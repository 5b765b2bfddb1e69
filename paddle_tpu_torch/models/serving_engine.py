"""Continuous-batching LLM serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/models/serving_engine.py``: ``submit``,
``cancel`` (and deadlines), ``step``, ``finished``, ``drain_stream``,
``run_to_completion``; on pool exhaustion the youngest request is
preempted and requeued.  Without a host page tier it resumes
recompute-style through the admission lanes.  With one
(``PagedKVCache(host_pages=N)``) a bytes-against-FLOPs cost model
(``_preempt_mode``) may swap the victim's private pages out to host RAM
instead, and its resume is one batched restore with zero prefill tokens
(``_admit_swapped``); a swap fault, a full host tier or a swap priced above
the re-prefill falls back to recompute, as in JAX.  Weights may be int8
(``quantize_params_int8``) and the cache's pages int8
(``PagedKVCache(kv_quant="int8")``), each independently of the other.

Three admission lanes, as in JAX:

* packed (the default): a wave packs every waiting context into one
  segmented-attention prefill;
* ``packed=False``: same-bucket contexts prefill as one dense batch
  (``_prefill``, RoPE through the fused RoPE kernel at head_dim 128), and
  a context longer than ``prefill_chunk`` advances chunk by chunk over
  its cached pages (``_prefill_chunk``);
* ``enable_prefix_caching=True``: each admission shares the cached full
  pages of its prompt's longest cached prefix (``alloc_row_prefix``) and
  registers its prompt's pages for later ones; on the packed lane the
  shared pages ride the stream as history slots (pool pages, or the
  stream itself for pages the same wave writes), on ``packed=False``
  every admission takes the chunked lane from its reused offset.

Three decode lanes, as in JAX:

* the synchronous lane (the default): one eager paged decode step for the
  whole batch, then a blocking fetch;
* ``overlap=True``, the dispatch-ahead pipeline: the loop state lives on
  the device and step k+1 is issued from step k's outputs before the host
  reads step k; the host drains one step (``lookahead`` steps) behind;
* ``decode_horizon=H``: one dispatch and one fetch cover H tokens, on
  either of the other two lanes.

``mixed=True`` (Sarathi-style piggybacking, as in JAX): once rows decode,
waiting prompts park as chunk state (their slot and pages claimed, no
prefill dispatch) and their context rides, ``mixed_token_budget`` tokens a
tick, inside the decode dispatches (:func:`make_mixed_step`), on the
synchronous and the ``overlap=True`` lanes; a completing segment samples
its first token in the same call and joins the decode batch on the device.
An idle engine, a zero budget and a context over ``mixed_ctx_cap`` admit
through the sequential packed wave.

``spec=SpecConfig(...)`` (speculative decoding, as in JAX): every decode
round is one call of :func:`make_spec_step` (a draft model's gamma + 1
micro-steps, or the host's prompt-lookup proposals, then the batched target
verify, the page scatter and the accept fold) committing up to gamma + 1
tokens a row, token-exact against plain greedy decoding, with one fetch a
round.  On the synchronous lane the round runs eagerly; with
``overlap=True`` a draft-model round replays from a CUDA graph chained off
the previous round's device state (prompt lookup keeps the synchronous
cadence: the host proposes from the committed tokens).

On a CUDA device every async, horizon and speculative overlap step replays
from a CUDA graph captured for its key (``models/graphed_step.py``); its
outputs reach the host through a ring of ``lookahead + 1`` pinned slots,
each copy queued behind its step and guarded by a CUDA event, and
``_fetch`` (waiting on that event) is the only blocking host sync of the
steady state.

Observability, as in JAX: the engine records into an
:class:`~paddle_tpu_torch.observability.EngineMetrics` bundle on a
registry of its own (``metrics_registry=None``), a shared one, or none
(``metrics_registry=False``), and emits its lifecycle events into a ring
(``metrics_ring``).  With a ``tracer`` each request carries a trace whose
phase clocks (queued, prefill, decode_active, preempted) advance at the
scheduler mutation points only and become spans once, at retirement.
Every instrument records a number the host already holds: no kernel
launch and no device sync is added on any lane.

Fault tolerance, as in JAX: a step exception quarantines the wave it
poisoned (``quarantine_faults=True``): every request the wave carried,
active or popped mid-admission, retires with ``status == "error"`` and the
exception's text, the in-flight dispatches drop (their copies waited on,
their tokens discarded), stranded slots and pages are reclaimed, and the
next ``step()`` admits from the queue.  ``max_consecutive_faults`` faults
in a row re-raise; :class:`EngineSupervisor` then rebuilds the engine from
a factory, carries the queue over and fails the requests whose pages died.
The fault plane (``paddle_tpu_torch/testing/faults.py``) fires its
``step_dispatch`` and ``prefill_dispatch`` sites at JAX's points, so one
rule poisons the same dispatch in both engines.

QoS, as in JAX: ``submit(priority=, tenant=)`` takes a class (``"high"``,
``"normal"``, ``"low"``) and a quota tenant.  A :class:`SchedulerPolicy`
orders the admission queue by (class, arrival), picks preemption victims
lowest class first (``admit_seq`` LIFO within a class), evicts strictly
lower-class work when the queue head finds no seat, and sheds overload by
class when the queue's soft bound trips: low rejects, normal admits
degraded (half its ``max_new_tokens``, spec off), high admits, both up to
``overload_factor`` times the bounds.  :class:`TenantQuotas` charges each
request's worst-case tokens to its tenant's token bucket.  A workload that
never names a class keeps the plain FIFO queue and its soft-bound 429.

Not ported yet, and refused at construction when asked for: TP meshes and
the quantized TP all-reduce (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observability import (EngineMetrics, MetricsRegistry, advance_phase,
                             bind_engine_gauges, finalize_request_trace)
from ..testing import faults
from . import graphed_step
from .llama_pretrain import LlamaPretrainConfig, _mm, _rms_norm
from .paged_decode import (PagedKVCache, _packed_prefill_body, _pick_token,
                           _prefill, _prefill_chunk, make_mixed_step,
                           make_paged_decode_step, make_spec_step)

__all__ = ["ContinuousBatchingEngine", "EngineDeadError", "EngineSupervisor",
           "PRIORITIES", "QueueFullError", "QuotaExceededError", "Request",
           "SchedulerPolicy", "SpecConfig", "TenantQuotas", "priority_rank"]

# priority classes, best first
PRIORITIES = ("high", "normal", "low")
_PRIO_RANK = {"high": 0, "normal": 1, "low": 2}


def priority_rank(priority: str) -> int:
    """Sort key of a priority class, 0 the best ("high").  An unknown
    string ranks as "normal": this orders, ``submit()`` validates."""
    return _PRIO_RANK.get(priority, 1)


class QueueFullError(RuntimeError):
    """``submit()`` refused by the bounded admission queue
    (``max_queue_len`` / ``max_queued_tokens``).  Carries a finite
    ``retry_after`` hint (seconds) priced off the engine's observed
    throughput; the HTTP front maps it to ``429`` + ``Retry-After``."""

    def __init__(self, why: str, retry_after: float = 1.0):
        super().__init__(why)
        self.retry_after = float(retry_after)


class QuotaExceededError(QueueFullError):
    """``submit()`` refused because the request's tenant is over its
    token-rate budget (:class:`TenantQuotas`), apart from the pool's own
    backpressure.  A :class:`QueueFullError`, so the HTTP front answers
    ``429``; ``retry_after`` is the bucket's time to hold this request's
    cost again."""

    def __init__(self, why: str, retry_after: float = 1.0,
                 tenant: Optional[str] = None):
        super().__init__(why, retry_after=retry_after)
        self.tenant = tenant


class TenantQuotas:
    """Per-tenant token buckets charged at admission: a tenant accrues
    ``rate_tokens_per_s`` up to ``burst_tokens`` (buckets start full) and
    each submission charges its worst-case cost (prompt +
    ``max_new_tokens``) up front, so one tenant's burst cannot spend
    another's capacity.  ``overrides`` maps a tenant to its own ``(rate,
    burst)``; ``tenant=None`` is unmetered.  Not locked: the engine and the
    fleet router call it behind their own serving lock."""

    def __init__(self, rate_tokens_per_s: float,
                 burst_tokens: Optional[float] = None,
                 overrides: Optional[Dict[str, tuple]] = None):
        if rate_tokens_per_s <= 0:
            raise ValueError("rate_tokens_per_s must be > 0, got "
                             f"{rate_tokens_per_s}")
        self.rate = float(rate_tokens_per_s)
        self.burst = float(burst_tokens if burst_tokens is not None
                           else rate_tokens_per_s)
        self.overrides = dict(overrides or {})
        self._buckets: Dict[str, list] = {}   # tenant -> [level, last t]

    def _limits(self, tenant: str) -> tuple:
        if tenant in self.overrides:
            rate, burst = self.overrides[tenant]
            return float(rate), float(burst)
        return self.rate, self.burst

    def charge(self, tenant: Optional[str], cost: float,
               now: float) -> None:
        """Take ``cost`` tokens from ``tenant``'s bucket or raise
        :class:`QuotaExceededError` with the refill time of the deficit
        (clamped to [0.1, 60] s).  All or nothing: a refused charge leaves
        the level as the refill made it."""
        if tenant is None:
            return
        rate, burst = self._limits(tenant)
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = [burst, now]
        level, last = bucket
        level = min(burst, level + (now - last) * rate)
        bucket[1] = now
        if cost > level:
            # a cost over the whole burst still gets a finite hint: the
            # time to refill the burst
            deficit = min(cost, burst) - level
            bucket[0] = level
            raise QuotaExceededError(
                f"tenant {tenant!r} over token-rate quota: cost "
                f"{cost:.0f} > bucket {level:.0f} (rate {rate:.0f} "
                f"tok/s, burst {burst:.0f})",
                retry_after=float(min(max(deficit / rate, 0.1), 60.0)),
                tenant=tenant)
        bucket[0] = level - cost


class SchedulerPolicy:
    """Which queued request admits next, which active one is evicted, and
    how overload sheds by class.  The default: admission by (class,
    arrival); victims lowest class first, ``admit_seq`` LIFO within a class;
    when the soft queue bound trips, reject low, degrade normal (half its
    ``max_new_tokens``, spec off), admit high, both up to
    ``overload_factor`` times the bounds.  Subclass it and pass
    ``ContinuousBatchingEngine(policy=...)`` to change a decision."""

    # how far past the soft bounds a protected class may queue
    overload_factor = 2.0

    def order_queue(self, queue: deque) -> deque:
        """The queue sorted by class, stably: arrival order, and a
        preempted request's place at the head, hold within a class."""
        return deque(sorted(queue,
                            key=lambda r: priority_rank(r.priority)))

    def select_victim(self, victims: List[int],
                      active: Dict[int, "Request"]) -> int:
        """The slot to evict among ``victims``: the lowest class, the most
        recently admitted within it."""
        return max(victims,
                   key=lambda s: (priority_rank(active[s].priority),
                                  active[s].admit_seq))

    def preemptable_for(self, head: "Request",
                        active: Dict[int, "Request"]) -> List[int]:
        """The slots the queue head may evict for a seat: every active
        request of a strictly lower class (equal classes are never
        churned)."""
        hr = priority_rank(head.priority)
        return [s for s, r in active.items()
                if priority_rank(r.priority) > hr]

    def shed(self, priority: str) -> str:
        """The verdict for a class when the soft bound trips:
        ``"reject"``, ``"degrade"`` or ``"admit"``."""
        if priority == "low":
            return "reject"
        if priority == "normal":
            return "degrade"
        return "admit"


class EngineDeadError(RuntimeError):
    """:class:`EngineSupervisor`'s restart budget is exhausted: the engine
    is unrecoverable and the serving front fails pending requests loudly
    instead of retrying forever."""


def _release_engine_claims(engine) -> None:
    """Best-effort release of every page and swap claim a dead engine
    holds: each slot off the free list (active rows and rows stranded
    mid-admission by a fatal step) and every parked swap record, so a cache
    that outlives the engine starts from clean page accounting
    (``PagedKVCache.audit()``).  A transplanted request whose record goes
    here resumes recompute-style."""
    for slot in range(engine.B):
        if slot in engine._free_slots:
            continue
        try:
            engine._release_slot(slot)
        except Exception:
            pass
    for handle in list(engine._swap_handles.values()):
        try:
            engine.cache.discard_swap(handle)
        except Exception:
            pass
    engine._swap_handles.clear()
    # claims beyond rows and swap records (a PrefillEngine's exported
    # hand-off records) release through this seam, so orphaned records
    # give their staging pages back
    extra = getattr(engine, "release_extra_claims", None)
    if extra is not None:
        try:
            extra()
        except Exception:
            pass


def _chip_flops_default(device) -> float:
    """The chip compute rate the preemption cost model assumes when
    ``offload_chip_flops`` is None: on a CUDA device the H100 SXM's
    data-sheet bf16 dense peak (989 TFLOP/s, the rate PERF.md's bounds
    use), else JAX's conservative CPU figure, so the CPU decisions equal
    JAX's."""
    return 989e12 if torch.device(device).type == "cuda" else 5e10


def _count_params(params) -> int:
    """Total parameter count over every tensor leaf (the 2 * N FLOPs a
    token estimate's N); engines cache it in ``_n_params``."""
    if torch.is_tensor(params):
        return params.numel()
    if isinstance(params, dict):
        return sum(_count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(_count_params(v) for v in params)
    return 0


def _drive_to_completion(driver, max_steps: int):
    """Step ``driver`` (an engine or a supervisor) until its queue drains;
    returns all finished requests in completion order."""
    out = []
    steps = 0
    while driver.has_work():
        driver.step()
        out.extend(driver.finished())
        steps += 1
        if steps > max_steps:
            raise RuntimeError("serving loop exceeded max_steps")
    return out


def _tid(req: "Request") -> Optional[str]:
    """Exemplar handle: the trace id behind a histogram observation
    (None with tracing off)."""
    return req.trace.trace_id if req.trace is not None else None


def _finalize_trace(req: "Request") -> None:
    """Retirement-time trace materialization: close the request's open
    phase interval at ``t_finish`` and report the accrued intervals as
    spans — the one place phase clocks become spans (never per decode
    step).  An engine-owned trace is closed here with the request's
    final status.  Never raises: tracing must not be able to break
    retirement."""
    try:
        ctx = req.trace
        if ctx is None:
            # the clocks close even with tracing off: the span-accounting
            # contract is on the Request
            if req.t_phase and req.phase != "done":
                advance_phase(req, "done",
                              now=req.t_finish if req.t_finish else None)
            return
        req.trace = None              # report + close exactly once
        finalize_request_trace(ctx, req, close=not ctx.managed,
                               tokens=len(req.generated),
                               preemptions=req.preempted)
    except Exception:
        pass


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # [len] int64
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    stop_sequences: Optional[List[List[int]]] = None
    admit_seq: int = -1                   # admission order (preemption)
    preempted: int = 0                    # times evicted + requeued
    # lifecycle timestamps (time.monotonic; 0.0 = not reached);
    # t_admit / t_first_token survive preemption
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    # absolute monotonic deadline (0.0 = none) and how the request ended:
    # "ok" (eos / stop / budget), "cancelled", "expired" or "error" (its
    # wave faulted); ``error`` carries the fault text of an errored ending
    deadline: float = 0.0
    status: str = "ok"
    error: Optional[str] = None
    # tracing: the current lifecycle phase and the monotonic instant it
    # began; each transition appends one closed (phase, t0, t1) interval
    # to phase_log, at scheduler mutation points only, never per token.
    # ``trace`` is the request's TraceContext (None with tracing off).
    phase: str = "queued"
    t_phase: float = 0.0
    phase_log: List = field(default_factory=list)
    trace: Optional[object] = None
    # the speculative toggle: None takes the engine's SpecConfig.default_on
    spec: Optional[bool] = None
    # QoS: the class (admission order, preemption victims), the quota
    # tenant, and whether overload shedding admitted it degraded
    priority: str = "normal"
    tenant: Optional[str] = None
    degraded: bool = False


@dataclass
class SpecConfig:
    """Speculative decoding as an engine lane:
    ``ContinuousBatchingEngine(spec=SpecConfig(...))`` makes every decode
    round one call of :func:`make_spec_step` committing up to ``gamma + 1``
    tokens a row, token-exact against plain greedy decoding.

    ``source``:

    * ``"draft"``: a draft model proposes; ``draft_cfg``, ``draft_params``
      and ``draft_cache`` (a :class:`PagedKVCache` of the engine's batch)
      are required, and its gamma + 1 micro-steps run in the same call as
      the verify;
    * ``"prompt_lookup"``: model-free n-gram drafting; the host matches the
      last ``ngram`` committed tokens against the request's own history and
      proposes the continuation of its earliest occurrence.  A miss costs
      acceptance, never content.

    ``adaptive_gamma`` retunes gamma each round from the acceptance EMA in
    ``[1, max_gamma]`` (one step function, and on the overlap lane one
    graph capture, per distinct gamma).  ``default_on`` is the per-request
    default; ``submit(spec=...)`` overrides it."""
    gamma: int = 4
    source: str = "draft"
    draft_cfg: Optional[LlamaPretrainConfig] = None
    draft_params: object = None
    draft_cache: Optional[PagedKVCache] = None
    adaptive_gamma: bool = False
    max_gamma: int = 8
    ngram: int = 3
    default_on: bool = True


class ContinuousBatchingEngine:
    """``submit()`` requests, call ``step()`` in a loop; finished requests
    appear in ``finished()``, per-token ``(rid, token)`` pairs in
    ``drain_stream()``.

    ``eos_id``: generation stops at this token (or at the request's
    ``max_new_tokens``).  The decode batch is the cache's batch size;
    packed admission streams are padded to a power-of-two number of
    ``prefill_bucket`` tokens.  Runs on the cache's device.

    ``packed=False`` admits through the batched lane (contexts of one
    ``prefill_bucket`` bucket prefill as one dense batch, padded to a
    power-of-two rows) and the chunked lane (a context longer than
    ``prefill_chunk``, rounded up to whole pages, prefills chunk by chunk
    over its cached pages); the packed lane ignores ``prefill_chunk``.
    ``enable_prefix_caching=True`` shares cached full prompt pages between
    requests; with ``packed=False`` every admission takes the chunked
    lane.

    ``overlap=True`` runs the dispatch-ahead pipeline: greedy output is
    token-exact against the synchronous lane, and the pipeline flushes at
    every scheduler mutation point (admission, preemption, a stop-sequence
    retirement, a cancel or deadline sweep).  ``lookahead`` is the number
    of dispatches the device may run ahead of the host.
    ``decode_horizon=H`` (H > 1) advances every active row by up to H
    tokens a dispatch over tables pre-claimed for the block; rows stop on
    the device at eos or budget, and a host-detected stop sequence trims
    the device's over-generated tail (at most H - 1 tokens, counted in
    ``horizon_trimmed_tokens``).

    ``mixed=True`` fuses up to ``mixed_token_budget`` prefill tokens
    (rounded up to whole pages) into every decode dispatch while rows
    decode; a context longer than ``mixed_ctx_cap`` (default 4 x the
    larger of the budget and ``prefill_bucket``, rounded down to pages)
    admits through one sequential packed wave (counted in
    ``mixed_degraded``).  It does not compose with
    ``decode_horizon > 1`` (``ValueError``).

    ``metrics_registry``: ``None`` records into a registry private to this
    engine, a :class:`MetricsRegistry` into that one, ``False`` records
    nothing; ``metrics_ring`` is the event ring (a private one by
    default); ``tracer`` (a :class:`~paddle_tpu_torch.observability.Tracer`)
    gives every submitted request a trace under its rid.

    ``spec=SpecConfig(...)`` decodes speculatively (greedy only; it does
    not compose with ``mixed=True`` or ``decode_horizon > 1``); each round
    commits up to ``gamma + 1`` tokens a row, on the synchronous lane or,
    for a draft model, on the overlap lane.

    ``quarantine_faults`` (default on) contains a step exception in the
    wave it poisoned; ``max_consecutive_faults`` faults in a row re-raise
    it (see :meth:`step`).

    ``policy`` (a :class:`SchedulerPolicy`, the default's when None) orders
    admission, picks preemption victims and sheds overload by class;
    ``tenant_quotas`` (a :class:`TenantQuotas`) meters tenants at
    ``submit()``."""

    def __init__(self, cfg: LlamaPretrainConfig, params,
                 cache: PagedKVCache, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_bucket: int = 64,
                 prefill_chunk: Optional[int] = None,
                 mesh=None, top_k: int = 0,
                 top_p: float = 1.0, enable_prefix_caching: bool = False,
                 metrics_registry=None, metrics_ring=None,
                 overlap: bool = False, lookahead: int = 1,
                 packed: bool = True,
                 max_queue_len: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 quarantine_faults: bool = True,
                 max_consecutive_faults: int = 3,
                 tp_allreduce: str = "fp32", mixed: bool = False,
                 mixed_token_budget: int = 256,
                 mixed_ctx_cap: Optional[int] = None,
                 decode_horizon: int = 1, spec=None, policy=None,
                 tenant_quotas=None, tracer=None):
        if int(decode_horizon) < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {decode_horizon}")
        if int(decode_horizon) > 1 and mixed:
            raise ValueError(
                "decode_horizon > 1 does not compose with mixed=True: the "
                "mixed tick re-plans its prefill stream on the host "
                "between consecutive dispatches, which an on-device "
                "multi-step program cannot replay -- use mixed=True "
                "(fused admission) OR decode_horizon (fused decode "
                "cadence), not both")
        if int(decode_horizon) > 1 and spec is not None:
            raise ValueError(
                "decode_horizon > 1 does not compose with spec: a "
                "speculative round IS the multi-token fused program (up "
                "to gamma+1 committed tokens per dispatch) -- tune "
                "spec.gamma instead of stacking a second horizon on top")
        later = {"mesh": mesh is not None,
                 "tp_allreduce": tp_allreduce != "fp32"}
        asked = [k for k, on in later.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported yet: {', '.join(asked)} (this engine has the "
                f"synchronous, overlap, horizon, mixed and speculative "
                f"lanes, packed, batched and chunked admission, prefix "
                f"caching and QoS; see ROADMAP.md)")
        self.cfg = cfg
        self.params = params
        self.cache = cache
        self.device = cache.device
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        # page-aligned buckets, so the page write sees whole pages
        page = cache.page
        self.prefill_bucket = ((max(prefill_bucket, page) + page - 1)
                               // page) * page
        # contexts longer than prefill_chunk (whole pages) prefill chunk by
        # chunk on the packed=False lanes
        if prefill_chunk is not None:
            prefill_chunk = ((max(prefill_chunk, page) + page - 1)
                             // page) * page
        self.prefill_chunk = prefill_chunk
        self.enable_prefix_caching = bool(enable_prefix_caching)
        self._packed = bool(packed)
        self.prefill_calls = 0            # admission dispatches
        self.prefill_token_slots = 0
        self.prefill_padded_tokens = 0
        self.decode_steps = 0
        self.tokens_generated = 0
        self.preemptions = 0
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.requests_expired = 0
        self.requests_rejected = 0
        self.resumes_recompute = 0        # preempted requests re-admitted
        self.resume_wall_s = 0.0          # all-resume admission waves' wall
        self.resume_events = 0
        # -- the host page tier: preemption may swap the victim's pages to
        # host RAM and resume with zero prefill tokens, when the cost model
        # below prices the swap under the re-prefill
        self._offload = cache.host is not None
        self._swap_handles: Dict[int, int] = {}   # rid -> swap handle
        self.prefill_tokens_avoided = 0
        self.resumes_swapped = 0
        # the cost model's knobs: the assumed swap bandwidth and chip rate
        # (None: _chip_flops_default)
        self.offload_swap_gbps = 10.0
        self.offload_chip_flops = None
        self._n_params = None             # counted on first use
        self.decode_wall_s = 0.0
        self.max_queue_len = max_queue_len
        self.max_queued_tokens = max_queued_tokens
        # QoS: class-ordered admission, class-aware victims and shedding,
        # tenant buckets charged at submit().  _has_priorities stays False
        # while every request is "normal", and the plain FIFO path runs
        self.policy = policy if policy is not None else SchedulerPolicy()
        self.quotas = tenant_quotas
        self._has_priorities = False
        self.requests_degraded = 0
        self.quota_rejected = 0
        # per-step exception handling: quarantine the poisoned wave up to
        # max_consecutive_faults faults in a row, then re-raise (only a
        # supervisor rebuild can help an engine that faults every step)
        self.quarantine_faults = bool(quarantine_faults)
        self.max_consecutive_faults = int(max_consecutive_faults)
        self._consecutive_faults = 0
        self._admitting: List[Request] = []   # popped, not yet active
        self.requests_faulted = 0
        self.step_faults = 0              # quarantined wave faults
        self.last_fault: Optional[str] = None
        self._cancelled: set = set()
        self._has_deadlines = False
        self._now = time.monotonic        # seam: tests pin the clock
        self.B = cache.tables.shape[0]
        self._free_slots = list(range(self.B))
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}       # slot -> request
        self._finished: List[Request] = []
        self._next_rid = 0
        self._admit_seq = 0
        self._stream: List = []     # (rid, token) in emission order
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # observability: host-side instruments only, recorded from values
        # the host already holds.  A registry private to this engine by
        # default (exact per-engine /metrics), a shared one to aggregate,
        # or metrics_registry=False for none
        self.tracer = tracer
        if metrics_registry is False:
            self.metrics = None
            cache.metrics = None     # a reused cache must not keep feeding
            #                          a prior engine's counters
        else:
            self.metrics = EngineMetrics(
                metrics_registry if metrics_registry is not None
                else MetricsRegistry(), ring=metrics_ring)
            bind_engine_gauges(self.metrics, self)
            cache.metrics = self.metrics
        self._step = make_paged_decode_step(cfg, temperature,
                                            kv_quant=cache.kv_quant,
                                            top_k=top_k, top_p=top_p)
        # int8 pages without history need no other packed prefill:
        # write_pages_batch quantizes; with history the q8 form
        # dequantizes the pool pages it gathers
        q8 = cache.kv_quant == "int8"
        self._prefill_packed = _packed_prefill_body(
            cfg, q8, self.enable_prefix_caching)
        self._prefill_dense = _prefill(cfg)
        self._prefill_chunked = _prefill_chunk(cfg, q8)
        # -- the mixed prefill + decode tick: the budget is page-aligned;
        # budget 0 leaves the sequential lanes alone
        budget_pages = 0
        if mixed and int(mixed_token_budget) > 0:
            budget_pages = -(-int(mixed_token_budget) // page)
        self.mixed_token_budget = budget_pages * page
        self._mixed = bool(mixed) and budget_pages > 0
        cap = (mixed_ctx_cap if mixed_ctx_cap is not None
               else 4 * max(self.mixed_token_budget, self.prefill_bucket))
        self.mixed_ctx_cap = max(int(cap) // page, 1) * page
        self._mixed_pref: Dict[int, dict] = {}    # slot -> chunk state
        self.mixed_ticks = 0              # dispatches that piggybacked
        self.mixed_prefill_tokens = 0     # fresh tokens piggybacked
        self.mixed_degraded = 0           # shape-forced sequential waves
        self._step_mixed = None
        if self._mixed:
            self._step_mixed = make_mixed_step(
                cfg, temperature, kv_quant=cache.kv_quant, top_k=top_k,
                top_p=top_p)
        # -- the speculative lane: one make_spec_step call a round
        self._spec = spec
        if spec is not None:
            self._init_spec(spec, temperature)
        self._next_tok = np.zeros((self.B,), np.int64)
        self._remaining = np.zeros((self.B,), np.int64)
        # the active slots, kept at admit / retire / preempt (the decode
        # loop never rebuilds it per token)
        self._active_mask = np.zeros((self.B,), np.int32)
        # -- the decode horizon and the dispatch-ahead pipeline ----------
        self.decode_horizon = int(decode_horizon)
        self.overlap = bool(overlap)
        self.lookahead = max(1, int(lookahead))
        graphed = self.overlap or self.decode_horizon > 1
        if (graphed and temperature > 0.0
                and self.device.type == "cuda"
                and not hasattr(torch.cuda.CUDAGraph,
                                "register_generator_state")):
            raise NotImplementedError(
                "sampling in a captured decode step needs "
                "CUDAGraph.register_generator_state, which this PyTorch "
                "lacks; use overlap=False, decode_horizon=1 to sample")
        # tokens a host-detected stop sequence discarded from a block
        self.horizon_trimmed_tokens = 0
        self._inflight: List[Dict] = []   # oldest-first undrained steps
        # the device-active mask at the dispatch of the oldest undrained
        # step (the drain reads tokens against it, then chains done masks)
        self._drain_active = np.zeros((self.B,), bool)
        self._dev = None                  # the seeded DecodeGraph
        self._dev_tables_version = -1
        self._needs_flush = False
        self._eos_dev = torch.tensor(-1 if eos_id is None else int(eos_id),
                                     dtype=torch.int64, device=self.device)
        # pinned host slots, one per step that may be in flight: each
        # holds the step's [3, H, B] outputs (tokens, done flags and a mixed
        # tick's first tokens), the host copies of the state a dispatch
        # uploads and a mixed tick's staging buffer, and is reused only
        # after its step drained (its event waited)
        self._ring: List[Dict] = []
        pin = self.device.type == "cuda"
        pm = cache.pages_max

        def host(shape, dt):
            return torch.zeros(shape, dtype=dt, pin_memory=pin)

        # a mixed tick's host arrays go up as one int32 buffer: the
        # stream's eight, the six per row and, on the synchronous lane,
        # the loop state
        stage_len = 0
        if self._mixed:
            stage_len = (8 * self._packed_bucket(self.mixed_ctx_cap)
                         + self.B * (pm + 10))

        def stage():
            return {"buf": host((stage_len,), torch.int32), "event": None}

        def spec_host():
            # a draft-model round on the overlap lane: its [3, C, B] out
            # (toks, dones, emits; flat, so that every gamma's view is
            # contiguous) and accepts, and the uploads of its extra state
            if spec is None or spec.source != "draft":
                return {}
            dpm = self._spec_dcache.pages_max
            return {"spec_out": host((3 * (self.max_gamma + 1) * self.B,),
                                     torch.int64),
                    "accepts": host((self.B,), torch.int64),
                    "prev": host((self.B,), torch.int64),
                    "spec_on": host((self.B,), torch.bool),
                    "dtables": host((self.B, dpm), torch.int32)}

        if graphed:
            self._ring = [{
                "out": host((3, self.decode_horizon, self.B), torch.int64),
                "tables": host((self.B, pm), torch.int32),
                "lens": host((self.B,), torch.int32),
                "tok": host((self.B,), torch.int64),
                "active": host((self.B,), torch.bool),
                "remaining": host((self.B,), torch.int64),
                "stage": stage() if self._mixed else None, **spec_host()}
                for _ in range(self.lookahead + 1)]
        # the synchronous lane's one staging buffer: each tick's fetch
        # waits for the step that read it
        self._mixed_stage = (stage() if self._mixed and not graphed
                             else None)
        self._ring_i = 0
        self.pipeline_flushes = 0         # mutation-point drains
        self.host_syncs = 0               # blocking device->host fetches

    def _init_spec(self, spec: SpecConfig, temperature: float) -> None:
        """Validate ``spec`` with JAX's texts and set up the speculative
        lane's state."""
        if temperature != 0.0:
            raise ValueError(
                "speculative serving is greedy-only (exact verification); "
                "temperature must be 0")
        if self._mixed:
            raise ValueError(
                "spec does not compose with mixed=True: the mixed tick "
                "re-plans its prefill stream on the host between "
                "consecutive dispatches, which the fused draft+verify "
                "program cannot replay -- use mixed=True (fused admission) "
                "OR spec (fused speculative decode), not both")
        if spec.source not in ("draft", "prompt_lookup"):
            raise ValueError(
                "SpecConfig.source must be 'draft' or 'prompt_lookup', got "
                f"{spec.source!r}")
        if int(spec.gamma) < 1:
            raise ValueError(f"spec.gamma must be >= 1, got {spec.gamma}")
        if spec.source == "draft":
            if spec.draft_cfg is None or spec.draft_params is None \
                    or spec.draft_cache is None:
                raise ValueError(
                    "SpecConfig(source='draft') needs draft_cfg, "
                    "draft_params and draft_cache (use "
                    "source='prompt_lookup' for model-free n-gram "
                    "drafting)")
            if spec.draft_cache.tables.shape[0] != self.B:
                raise ValueError(
                    f"draft_cache batch {spec.draft_cache.tables.shape[0]} "
                    f"!= target cache batch {self.B}")
        self.gamma = int(spec.gamma)
        self.adaptive_gamma = bool(spec.adaptive_gamma)
        self.max_gamma = max(int(spec.max_gamma), self.gamma)
        self._accept_ema = float(self.gamma)
        self.spec_rounds = 0
        self.spec_accepted = 0
        self.spec_drafted = 0             # draft tokens proposed
        draft = spec.source == "draft"
        self._spec_dcfg = spec.draft_cfg if draft else None
        self._spec_dparams = spec.draft_params if draft else None
        self._spec_dcache = spec.draft_cache if draft else None
        self._spec_prefill = _prefill(spec.draft_cfg) if draft else None
        self._spec_on = np.zeros((self.B,), bool)
        self._prev_tok = np.zeros((self.B,), np.int64)
        self._spec_seq: Dict[int, list] = {}      # prompt-lookup history
        self._spec_ngrams: Dict[int, dict] = {}
        self._dev_dtables_version = -1
        if self.metrics is not None:
            self.metrics.spec_gamma.set(self.gamma)

    # -- client side ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               stop_sequences=None,
               deadline_s: Optional[float] = None,
               trace=None, spec: Optional[bool] = None,
               priority: str = "normal",
               tenant: Optional[str] = None) -> int:
        """Queue a request.  An empty or oversized request fails HERE
        with ``ValueError`` (never mid ``step()``); a full admission
        queue fails with :class:`QueueFullError`.

        ``stop_sequences``: token-id lists; generation retires as soon as
        the generated tail equals one of them.  ``deadline_s``: seconds
        from now after which the request is retired (queued or active)
        with ``status == "expired"``.  ``spec``: the request's speculative
        toggle (``None`` takes ``SpecConfig.default_on``); spec-off rows
        ride the same round with one plain greedy token.  ``spec=True`` on
        an engine built without ``spec=SpecConfig(...)`` raises.
        ``trace``: a trace context minted above the engine (a fleet
        router's, under its rid); None begins one on the engine's tracer.

        ``priority``: ``"high"``, ``"normal"`` or ``"low"``.  When the
        queue's soft bound trips, the policy sheds by class (low raises
        :class:`QueueFullError`, normal admits ``degraded``, high admits),
        both admitting up to ``policy.overload_factor`` times the bounds;
        while no request has named a class the soft bound refuses every
        request, as before.  ``tenant``: the key ``tenant_quotas`` charges
        the worst-case tokens to, after the shed verdict; over budget
        raises :class:`QuotaExceededError`.  None is unmetered."""
        prompt = np.asarray(prompt, np.int64)
        if prompt.size == 0:
            raise ValueError(
                "prompt must contain at least one token (empty prompts "
                "cannot be admitted)")
        # bound by BOTH the row's table width and the whole pool (page 0
        # is reserved): a request the pool cannot hold even alone would
        # wedge the engine
        row_cap = min(self.cache.pages_max,
                      self.cache.num_pages - 1) * self.cache.page
        worst = len(prompt) + max_new_tokens
        if worst > row_cap:
            raise ValueError(
                f"request needs up to {worst} cache slots (prompt "
                f"{len(prompt)} + max_new_tokens {max_new_tokens}) > row "
                f"capacity {row_cap} (min(pages_max "
                f"{self.cache.pages_max}, usable pages "
                f"{self.cache.num_pages - 1}) x page {self.cache.page})")
        stops = None
        if stop_sequences is not None:
            if not isinstance(stop_sequences, (list, tuple)):
                raise ValueError(
                    "stop_sequences must be a list of token-id "
                    f"sequences, got {type(stop_sequences).__name__}")
            stops = []
            for q in stop_sequences:
                if not isinstance(q, (list, tuple, np.ndarray)) \
                        or len(q) == 0:
                    raise ValueError(
                        "each stop sequence must be a NON-EMPTY list of "
                        f"token ids, got {q!r}")
                stops.append([int(t) for t in q])
        if spec and self._spec is None:
            raise ValueError(
                "spec=True needs an engine built with spec=SpecConfig(...): "
                "the fused draft+verify program is built at engine "
                "construction")
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        degraded = False
        why = self.queue_capacity_reason(len(prompt))
        if why is not None:
            # the soft bound tripped: shed by class, the protected classes
            # only up to the hard bound.  A workload that never named a
            # class keeps the plain refusal at the soft bound
            if self._has_priorities or priority != "normal":
                verdict = self.policy.shed(priority)
            else:
                verdict = "reject"
            if verdict == "reject":
                self._reject(why)
            hard = self.queue_capacity_reason(
                len(prompt), factor=self.policy.overload_factor)
            if hard is not None:
                self._reject(f"{hard} [hard bound, class {priority!r}]")
            if verdict == "degrade":
                max_new_tokens = max(1, int(max_new_tokens) // 2)
                spec = False if self._spec is not None else spec
                degraded = True
                self.requests_degraded += 1
                if self.metrics is not None:
                    self.metrics.requests_degraded.inc()
                    self.metrics.ring.emit(
                        "request_degraded", reason=why, priority=priority,
                        tenant=tenant, max_new_tokens=int(max_new_tokens))
        if self.quotas is not None:
            # after the verdict: a rejected request costs its tenant
            # nothing, a degraded one its halved budget
            try:
                self.quotas.charge(tenant,
                                   len(prompt) + int(max_new_tokens),
                                   now=self._now())
            except QuotaExceededError:
                self.quota_rejected += 1
                if self.metrics is not None:
                    self.metrics.quota_rejected.inc()
                    self.metrics.ring.emit("quota_rejected", tenant=tenant,
                                           priority=priority)
                raise
        deadline = 0.0
        if deadline_s is not None:
            deadline = self._now() + float(deadline_s)
            self._has_deadlines = True
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, stop_sequences=stops,
                      t_submit=time.monotonic(), deadline=deadline,
                      spec=spec, priority=priority, tenant=tenant,
                      degraded=degraded)
        if priority != "normal":
            self._has_priorities = True
        # phase accounting starts at the queue; a trace minted above the
        # engine wins over the engine's own tracer
        req.t_phase = req.t_submit
        if trace is None and self.tracer is not None:
            trace = self.tracer.begin_trace(
                str(rid), prompt_len=len(prompt),
                max_new_tokens=int(max_new_tokens))
        req.trace = trace
        self._queue.append(req)
        if self.metrics is not None:
            self.metrics.requests_submitted.inc()
            self.metrics.ring.emit("request_submitted", rid=rid,
                                   prompt_len=len(prompt),
                                   max_new_tokens=max_new_tokens,
                                   priority=priority, tenant=tenant)
        return rid

    def _reject(self, why: str) -> None:
        self.requests_rejected += 1
        if self.metrics is not None:
            self.metrics.requests_rejected.inc()
            self.metrics.ring.emit("request_rejected", reason=why)
        raise QueueFullError(why, retry_after=self.retry_after_s())

    def cancel(self, rid: int) -> bool:
        """Mark a queued or active request for cancellation; it retires at
        the start of the next ``step()`` with ``status == "cancelled"``.
        Returns False when the rid is unknown or already finished."""
        if any(r.rid == rid for r in self._queue) or \
                any(r.rid == rid for r in self._active.values()) or \
                any(e["req"].rid == rid
                    for e in tuple(self._mixed_pref.values())):
            self._cancelled.add(rid)
            return True
        return False

    def queued_tokens(self) -> int:
        """Context tokens of pending prefill work: the queue (a preempted
        request counts its regenerated context too) plus the remainder of
        rows parked mid-prefill on the mixed lane (they left the queue,
        but their prefill is still owed).  Sums over ``tuple()`` copies,
        so scrape threads call it lock-free."""
        owed = sum(len(e["ctx"]) - e["pos"]
                   for e in tuple(self._mixed_pref.values()))
        return owed + sum(len(r.prompt) + len(r.generated)
                          for r in tuple(self._queue))

    def queued_by_class(self) -> Dict[str, int]:
        """Waiting requests per priority class, rows parked mid-prefill
        included.  Iterates ``tuple()`` copies, so scrape threads call it
        lock-free."""
        out = {p: 0 for p in PRIORITIES}
        for r in tuple(self._queue):
            out[r.priority if r.priority in out else "normal"] += 1
        for e in tuple(self._mixed_pref.values()):
            p = e["req"].priority
            out[p if p in out else "normal"] += 1
        return out

    def queue_capacity_reason(self, prompt_len: int = 0,
                              factor: float = 1.0,
                              priority: Optional[str] = None
                              ) -> Optional[str]:
        """Why the bounded admission queue would refuse a submission now,
        or ``None`` while capacity remains: the one predicate behind
        ``submit()``'s backpressure, the server's ``/health/ready`` and the
        fleet router's placement.  ``factor`` scales both bounds (the shed
        path asks the hard bound); ``priority`` asks whether ``submit()``
        would reject that class now (a class the policy protects is
        measured against the hard bound, as ``submit()`` measures it)."""
        if priority is not None and \
                (self._has_priorities or priority != "normal") and \
                self.policy.shed(priority) != "reject":
            factor = max(factor, self.policy.overload_factor)
        if self.max_queue_len is not None:
            bound = int(self.max_queue_len * factor)
            if len(self._queue) >= bound:
                return (f"admission queue full: {len(self._queue)} waiting "
                        f">= max_queue_len {bound}")
        if self.max_queued_tokens is not None:
            bound = int(self.max_queued_tokens * factor)
            waiting = self.queued_tokens()
            need = max(int(prompt_len), 1)
            if waiting + need > bound:
                return (f"queued tokens {waiting} + prompt {need} > "
                        f"max_queued_tokens {bound}")
        return None

    def retry_after_s(self) -> float:
        """Back-off hint for a rejected client: queued tokens priced at
        the observed decode throughput, clamped to [0.1, 60] s (1 s while
        nothing has been measured)."""
        if self.decode_wall_s > 0 and self.tokens_generated > 0:
            rate = self.tokens_generated / self.decode_wall_s
            est = self.queued_tokens() / max(rate, 1e-6)
        else:
            est = 1.0
        return float(min(max(est, 0.1), 60.0))

    def finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def drain_stream(self) -> List:
        """All ``(rid, token)`` pairs emitted since the last drain, in
        emission order."""
        out, self._stream = self._stream, []
        return out

    def has_work(self) -> bool:
        return bool(self._queue or self._active or self._mixed_pref)

    def run_to_completion(self, max_steps: int = 10_000):
        """Drive until the queue drains; returns all finished requests
        in completion order."""
        return _drive_to_completion(self, max_steps)

    # -- engine side ------------------------------------------------------
    @staticmethod
    def _ctx_of(req: Request) -> np.ndarray:
        """The tokens a (re-)prefill must cache: the prompt, plus, for a
        preempted request, everything generated except the last token
        (generated[-1] is the not-yet-fed next input)."""
        if req.generated:
            return np.concatenate(
                [req.prompt, np.asarray(req.generated[:-1], np.int64)])
        return req.prompt

    def _hit_stop(self, req: Request, t: int) -> bool:
        """eos or a completed stop sequence at the generated tail."""
        if self.eos_id is not None and t == self.eos_id:
            return True
        for seq in req.stop_sequences or ():
            if len(req.generated) >= len(seq) and \
                    req.generated[-len(seq):] == seq:
                return True
        return False

    def _note_first_token(self, req: Request) -> None:
        """TTFT sample, once per request (the first token lands at
        admission; a preemption resume must not observe again)."""
        if req.t_first_token == 0.0 and req.generated:
            req.t_first_token = time.monotonic()
            if self.metrics is not None:
                self.metrics.ttft.observe(
                    req.t_first_token - req.t_submit, exemplar=_tid(req))

    def _spec_admit(self, req: Request, slot: int, tok: int) -> None:
        """The speculative admission tail: the row's on / off toggle, the
        ``prev`` mirror and its draft source -- a dense draft-model prefill
        of the committed context into the draft cache (``source="draft"``;
        the fused RoPE kernel at head_dim 128) or the request's n-gram
        table (``source="prompt_lookup"``).  Runs for fresh admissions and
        recompute resumes alike."""
        on = req.spec if req.spec is not None else self._spec.default_on
        self._spec_on[slot] = bool(on)
        ctx = self._ctx_of(req)
        self._prev_tok[slot] = int(ctx[-1])
        if not on:
            return
        if self._spec.source == "draft":
            dcache = self._spec_dcache
            L = len(ctx)
            dcache.alloc_row(slot, L)
            Lp = -(-L // dcache.page) * dcache.page
            padded = np.zeros((1, Lp), np.int64)
            padded[0, :L] = ctx
            _, ks, vs = self._spec_prefill(
                self._spec_dparams, torch.from_numpy(padded).to(self.device))
            dcache.write_row_pages(slot, ks[:, 0], vs[:, 0], L)
        else:
            seq = [int(t) for t in ctx] + [int(tok)]
            self._spec_seq[slot] = seq
            n = self._spec.ngram
            tab: dict = {}
            # the first occurrence wins: a proposal continues the earliest
            # prior match, not the tail itself
            for i in range(n, len(seq)):
                tab.setdefault(tuple(seq[i - n:i]), i)
            self._spec_ngrams[slot] = tab

    def _finish_admit(self, req: Request, slot: int, tok: int) -> None:
        """Shared bookkeeping tail of an admission."""
        if self._spec is not None:
            self._spec_admit(req, slot, tok)
        if req.t_admit == 0.0:
            req.t_admit = time.monotonic()
            if self.metrics is not None:
                self.metrics.queue_wait.observe(
                    req.t_admit - req.t_submit, exemplar=_tid(req))
        # phase-clock transition: the queue / prefill wave closes here and
        # decoding begins
        advance_phase(req, "decode_active")
        self._note_first_token(req)
        req.slot = slot
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self._active[slot] = req
        self._next_tok[slot] = tok
        self._remaining[slot] = req.max_new_tokens - len(req.generated)
        self._active_mask[slot] = 1
        if self._hit_stop(req, tok) or self._remaining[slot] <= 0:
            self._retire(slot)

    def _release_slot(self, slot: int) -> None:
        """Free a slot's cache rows, the main one and the speculative
        lane's (the second even when the first raises)."""
        try:
            self.cache.release_row(slot)
        finally:
            self._release_aux(slot)

    def _release_aux(self, slot: int) -> None:
        """Release a slot's speculative state: its draft-cache row and its
        prompt-lookup history."""
        if self._spec is None:
            return
        if self._spec_dcache is not None and self._spec_on[slot]:
            self._spec_dcache.release_row(slot)
        self._spec_on[slot] = False
        self._spec_seq.pop(slot, None)
        self._spec_ngrams.pop(slot, None)

    def _free_slot(self, slot: int) -> None:
        self._release_slot(slot)
        self._free_slots.append(slot)
        self._remaining[slot] = 0
        self._active_mask[slot] = 0

    def _retire(self, slot: int) -> None:
        """Retire an active request that ended normally (eos, stop
        sequence or budget)."""
        req = self._active.pop(slot)
        req.done = True
        req.status = "ok"
        req.t_finish = time.monotonic()
        self._free_slot(slot)
        self.requests_finished += 1
        if self.metrics is not None:
            m = self.metrics
            m.requests_finished.inc()
            n = len(req.generated)
            if n > 1 and req.t_first_token and not req.preempted:
                # mean inter-token time over the decode phase (TTFT has
                # its own histogram); a preempted request's window spans
                # its requeue wait, so it is left out
                m.tpot.observe(
                    (req.t_finish - req.t_first_token) / (n - 1),
                    exemplar=_tid(req))
            m.ring.emit("request_finished", rid=req.rid, tokens=n,
                        preempted=req.preempted)
        _finalize_trace(req)
        self._finished.append(req)

    # -- fault tolerance: abnormal retirement -----------------------------
    def _count_abnormal(self, req: Request, status: str) -> None:
        """The one bookkeeping site of every ending but "ok" (the plain
        counters and the registry's stay in lockstep)."""
        if status == "cancelled":
            self.requests_cancelled += 1
        elif status == "expired":
            self.requests_expired += 1
        else:
            self.requests_faulted += 1
        if self.metrics is not None:
            m = self.metrics
            {"cancelled": m.requests_cancelled,
             "expired": m.requests_expired}.get(
                 status, m.requests_faulted).inc()
            m.ring.emit("request_aborted", rid=req.rid, status=status,
                        generated=len(req.generated))

    def _retire_abnormal(self, slot: int, status: str,
                         error: Optional[str] = None) -> None:
        """Retire an active request outside the normal path (cancelled,
        expired, or its wave faulted): its pages free through
        ``release_row`` and it lands in ``finished()`` with ``status``
        and ``error``.  No TPOT sample.  The request is failed and
        finished even when the release raises: a client always gets a
        terminal message, whatever the cache's state."""
        req = self._active.pop(slot)
        req.done = True
        req.status = status
        req.error = error
        req.t_finish = time.monotonic()
        try:
            self._release_slot(slot)
        finally:
            self._free_slots.append(slot)
            self._remaining[slot] = 0
            self._active_mask[slot] = 0
            self._count_abnormal(req, status)
            _finalize_trace(req)
            self._finished.append(req)

    def _finish_queued_abnormal(self, req: Request, status: str,
                                error: Optional[str] = None) -> None:
        """Retire a request that holds no slot (queued, or popped by an
        admission that faulted) with ``status`` and ``error``.  Its swap
        record, the one resource a queued request can hold, is discarded:
        its host pages free and its held device refs release."""
        handle = self._swap_handles.pop(req.rid, None)
        if handle is not None:
            self.cache.discard_swap(handle)
        req.done = True
        req.status = status
        req.error = error
        req.t_finish = time.monotonic()
        self._count_abnormal(req, status)
        _finalize_trace(req)
        self._finished.append(req)

    def _sweep_cancelled_expired(self) -> None:
        """Retire cancelled / deadline-expired requests, queued or
        active, at the start of a step.  Active ones release their slot
        only after the pipeline drains: an in-flight dispatch still writes
        their pages."""
        if not self._cancelled and not self._has_deadlines:
            return
        now = self._now()

        def _hit(req: Request) -> Optional[str]:
            if req.rid in self._cancelled:
                return "cancelled"
            if req.deadline and now >= req.deadline:
                return "expired"
            return None

        keep: deque = deque()
        for req in self._queue:
            status = _hit(req)
            if status is None:
                keep.append(req)
            else:
                self._finish_queued_abnormal(req, status)
        self._queue = keep
        victims = [(slot, req, status)
                   for slot, req in list(self._active.items())
                   for status in (_hit(req),) if status is not None]
        # rows parked mid-prefill hold a slot and pages: they release
        # after the same flush (an in-flight mixed tick still writes them)
        parked = [(slot, ent, status)
                  for slot, ent in list(self._mixed_pref.items())
                  for status in (_hit(ent["req"]),) if status is not None]
        if (victims or parked) and self.overlap:
            self._pipeline_flush()
        for slot, req, status in victims:
            # the flush may have retired the victim normally (eos or
            # budget landed on the device first): that stands
            if self._active.get(slot) is req:
                self._retire_abnormal(slot, status)
        for slot, ent, status in parked:
            if self._mixed_pref.get(slot) is not ent:
                continue
            del self._mixed_pref[slot]
            try:
                self._release_slot(slot)
            finally:
                # the terminal message even when the release raises, as
                # _retire_abnormal gives it
                self._free_slots.append(slot)
                self._remaining[slot] = 0
                self._active_mask[slot] = 0
                self._finish_queued_abnormal(ent["req"], status)
        self._cancelled.clear()

    def step(self) -> int:
        """Admit + one decode token for every active slot.  Returns the
        number of active requests after the step.

        With ``quarantine_faults`` (default) a step exception does not
        kill the engine: the poisoned wave quarantines (every request it
        carried retires with ``status == "error"``, the in-flight
        dispatches drop) and the next ``step()`` admits from the queue.
        ``max_consecutive_faults`` faults in a row re-raise: a fault on
        every step means the engine itself is broken, and only a
        supervisor rebuild (:class:`EngineSupervisor`) can help."""
        try:
            n = self._step_inner()
        except Exception as exc:
            if not self.quarantine_faults:
                raise
            self._consecutive_faults += 1
            if self._consecutive_faults > self.max_consecutive_faults:
                raise
            self._quarantine(exc)
            return len(self._active)
        self._consecutive_faults = 0
        return n

    def _quarantine(self, exc: BaseException) -> None:
        """Contain a step fault: drop the poisoned in-flight dispatches
        (after their copies land, so no pinned ring slot is rewritten
        under a queued copy; their tokens die with the wave), retire every
        request the wave carried with an error, and leave the queue and
        the allocator ready for the next step.  The waits are the only
        ones off ``_fetch``, and on this path only."""
        text = f"{type(exc).__name__}: {exc}"
        self.last_fault = text
        self.step_faults += 1
        stages = [s["stage"] for s in self._ring] + [self._mixed_stage]
        for ev in [e["event"] for e in self._inflight] + [
                s["event"] for s in stages if s is not None]:
            # a mixed tick that raised after its staging upload leaves
            # the copy queued: wait for it too, before the buffer is reused
            if ev is not None:
                try:
                    ev.synchronize()
                except Exception:
                    pass               # a poisoned context: nothing to save
        self._inflight.clear()
        self._dev = None
        self._needs_flush = False
        self._drain_active = np.zeros((self.B,), bool)
        if self.cache.host is not None:
            try:
                # staged swap-out copies predate the fault: dropping them
                # would corrupt parked rows
                self.cache.host.flush()
            except Exception:
                pass
        for slot in list(self._active):
            try:
                self._retire_abnormal(slot, "error", text)
            except Exception:
                # the allocator refused the release: the request is failed
                # and finished already (_retire_abnormal's finally); a
                # recurrence escalates to the supervisor
                pass
        # requests the faulted step popped off the queue but did not yet
        # commit to _active (an admission-phase fault) fail loudly too
        for req in self._admitting:
            if req.done or (req.slot is not None
                            and self._active.get(req.slot) is req):
                continue
            try:
                # also discards a record a faulted swap-in left parked
                self._finish_queued_abnormal(req, "error", text)
            except Exception:
                # the discard raised: the request still ends loudly
                req.done, req.status, req.error = True, "error", text
                req.t_finish = time.monotonic()
                _finalize_trace(req)
                self._finished.append(req)
        self._admitting = []
        # rows parked mid-prefill die with the wave: the dispatches that
        # carried their context dropped; the sweep below reclaims their
        # slots and pages
        for ent in self._mixed_pref.values():
            if not ent["req"].done:
                self._finish_queued_abnormal(ent["req"], "error", text)
        self._mixed_pref.clear()
        # reclaim slots stranded mid-admission: off the free list (their
        # rows may hold freshly claimed pages) but never made active
        for slot in range(self.B):
            if slot in self._active or slot in self._free_slots:
                continue
            try:
                self._release_slot(slot)
            except Exception:
                pass
            self._free_slots.append(slot)
            self._remaining[slot] = 0
            self._active_mask[slot] = 0
        if self.metrics is not None:
            self.metrics.ring.emit("engine_quarantine", error=text,
                                   consecutive=self._consecutive_faults)

    def _step_inner(self) -> int:
        self._sweep_cancelled_expired()
        if self._mixed and (self._active or self._mixed_pref):
            # the mixed lane: decode never pauses to admit; waiting prompts
            # park and ride inside the decode dispatches.  An idle mixed
            # engine admits through the sequential wave: no decode latency
            # to protect, and one wave admits a cold batch faster
            self._mixed_carve()
        else:
            self._admit_wave()
        if not self._active and not self._mixed_pref:
            return 0
        t0 = time.perf_counter()
        if self._mixed_pref:
            self._decode_mixed()
        else:
            self._decode_once()
        dt = time.perf_counter() - t0
        self.decode_wall_s += dt
        if self.metrics is not None:
            # the host wall of the tick: on the graph lanes the dispatch
            # plus the drain, not device time
            self.metrics.decode_seconds.observe(dt)
        return len(self._active)

    def _order_queue(self) -> None:
        """Class-order the queue (``policy.order_queue``; stable, so arrival
        order holds within a class).  Skipped while every request is
        "normal"."""
        if self._has_priorities and len(self._queue) > 1:
            self._queue = self.policy.order_queue(self._queue)

    def _pages_needed(self, req: Request) -> int:
        """The device pages ``req``'s admission claims: its restore's when
        it is swapped out (its shared pages are held already), else its
        context's."""
        handle = self._swap_handles.get(req.rid)
        if handle is not None:
            return self.cache.swap_pages_needed(handle)
        return -(-len(self._ctx_of(req)) // self.cache.page)

    def _collect_admissions(self):
        """Pop every queued request that fits (slots + pool pages),
        head-of-line FIFO within a class (the queue class-ordered first):
        stop at the first that does not fit.  A swapped-out request gates
        on the device pages its restore claims (its shared pages are held
        already) and bypasses the prefill lanes.  -> ``(admits,
        swap_ins)``: (request, context) pairs to prefill, and requests to
        restore."""
        self._order_queue()
        admits: List = []                    # (request, context) pairs
        swap_ins: List = []                  # swapped-row restores
        reserved = 0
        while self._queue and \
                len(self._free_slots) > len(admits) + len(swap_ins):
            head = self._queue[0]
            need = self._pages_needed(head)
            if reserved + need > self.cache.available_pages():
                break
            reserved += need
            if head.rid in self._swap_handles:
                swap_ins.append(self._queue.popleft())
                continue
            ctx = self._ctx_of(head)
            if head.generated:               # recompute-style resume
                self.resumes_recompute += 1
                if self.metrics is not None:
                    self.metrics.preempt_resume_recompute.inc()
            admits.append((self._queue.popleft(), ctx))
        return admits, swap_ins

    def _admit_wave(self) -> None:
        """The sequential admission path: pop everything that fits, flush
        the pipeline (admission is a scheduler mutation), restore the
        swapped-out requests and prefill the rest as one wave through the
        packed, batched or chunked lane."""
        admits, swap_ins = self._collect_admissions()
        while not admits and not swap_ins and not self._active \
                and self._queue and self._degrade_one_swap():
            # nothing fits and nothing runs: parked swap records are all
            # that still pins pages; degrade them to recompute resumes
            # until the head of the queue fits
            admits, swap_ins = self._collect_admissions()
        while self._has_priorities and not admits and not swap_ins \
                and self._queue and self._priority_preempt():
            # priority preemption: the class-ordered head finds no seat
            # while strictly lower-class work holds slots or pages; evict
            # one victim a turn through the swap / recompute path until the
            # head fits or no lower-class victim is left
            admits, swap_ins = self._collect_admissions()
        if not admits and not swap_ins:
            return
        # requests popped off the queue but not yet active: a fault from
        # here on (the flush's drains included) fails them loudly in
        # _quarantine, never drops them with the stack
        self._admitting = [req for req, _ in admits] + list(swap_ins)
        if self.overlap:
            # admission is a scheduler mutation: drain the pipeline before
            # slots and pages move under it
            self._pipeline_flush()
        failed = [req for req in swap_ins if not self._admit_swapped(req)]
        for req in reversed(failed):
            # FIFO: the oldest failed resume stays at the head for its
            # recompute admission
            self._queue.appendleft(req)
        self._admitting = [req for req, _ in admits]
        all_resumes = bool(admits) and all(r.generated for r, _ in admits)
        t_adm = time.perf_counter()
        if admits:
            self._admit_sequential(admits)
        self._admitting = []          # every admit committed to _active
        if all_resumes:
            # an all-resume recompute wave's admission wall is the resume
            # latency, attributed per request (comparable with the
            # per-request swap-in samples)
            dt = time.perf_counter() - t_adm
            self.resume_wall_s += dt
            self.resume_events += len(admits)
            if self.metrics is not None:
                self.metrics.preempt_resume_seconds.observe(
                    dt / len(admits))

    def _priority_preempt(self) -> bool:
        """Evict one active request of a class strictly below the queue
        head's (the policy's victim), the pipeline drained first on the
        overlap lane.  False when there is none: equal classes are never
        churned."""
        victims = self.policy.preemptable_for(self._queue[0], self._active)
        if not victims:
            return False
        if self.overlap:
            self._pipeline_flush()
            # the drain may have retired rows
            victims = [s for s in victims if s in self._active]
            if not victims:
                return True           # pages freed with no preemption
        return self._preempt(keep=None, only=victims)

    def _admit_swapped(self, req: Request) -> bool:
        """Re-admit a swapped-out request: restore its parked pages (one
        batched restore) and rebuild its table -- zero prefill tokens, no
        sampling (its next input is saved).  On device-pool exhaustion the
        record is dropped and False returns (the caller requeues it for a
        recompute admission).  Any other exception returns the slot and
        leaves the record mapped: the quarantine and restart paths discard
        it through ``_finish_queued_abnormal``."""
        t0 = time.perf_counter()
        handle = self._swap_handles[req.rid]
        slot = self._free_slots.pop()
        try:
            restored = self.cache.swap_in_row(slot, handle)
        except RuntimeError:
            del self._swap_handles[req.rid]
            self.cache.discard_swap(handle)
            self._free_slots.append(slot)
            return False
        except BaseException:
            self._free_slots.append(slot)
            raise
        del self._swap_handles[req.rid]
        self.prefill_tokens_avoided += restored
        self.resumes_swapped += 1
        dt = time.perf_counter() - t0
        self.resume_wall_s += dt
        self.resume_events += 1
        if self.metrics is not None:
            m = self.metrics
            m.preempt_resume_swapped.inc()
            m.prefill_tokens_avoided.inc(restored)
            m.preempt_resume_seconds.observe(dt)
            m.ring.emit("swap_resume", rid=req.rid, slot=slot,
                        tokens=restored)
        self._finish_admit(req, slot, req.generated[-1])
        if req.trace is not None:
            # the span after the admission commit: the restored row's claim
            # is committed before anything fallible runs
            t1 = time.monotonic()
            req.trace.span("swap_in", t1 - dt, t1, slot=slot,
                           tokens=restored)
        return True

    def _preempt_mode(self, slot: int) -> str:
        """The bytes-against-FLOPs preemption cost model: ``"swap"`` when
        parking the victim's private pages in the host tier and restoring
        them (twice their bytes at ``offload_swap_gbps``) costs less than
        re-prefilling its context (``2 * N_params`` FLOPs a token at
        ``offload_chip_flops``), else ``"recompute"``; recompute too with
        no host tier or one without room."""
        if not self._offload:
            return "recompute"
        cache = self.cache
        L = int(cache.lens[slot])
        private = cache.private_pages(slot)
        if private == 0:
            return "swap"         # all pages shared: nothing moves, and
            #                       the resume still skips the prefill
        if cache.host_available() < private:
            return "recompute"    # host tier full
        if self._n_params is None:
            self._n_params = _count_params(self.params)
        chip = self.offload_chip_flops
        if chip is None:
            chip = _chip_flops_default(self.device)
        swap_s = (2.0 * private * cache.page_bytes
                  / (self.offload_swap_gbps * 1e9))
        recompute_s = 2.0 * self._n_params * L / chip
        return "swap" if swap_s < recompute_s else "recompute"

    def _degrade_one_swap(self) -> bool:
        """Last-resort page reclamation: drop one parked swap record (its
        request falls back to a recompute resume), releasing its held
        device refs and its host pages, so swap records never wedge the
        allocator.  -> whether a record was dropped."""
        if not self._swap_handles:
            return False
        rid = next(iter(self._swap_handles))
        self.cache.discard_swap(self._swap_handles.pop(rid))
        return True

    def _admit_sequential(self, admits: List) -> None:
        """The lane of one popped admission wave: the packed lane (any
        length mix is one dispatch; ``prefill_chunk`` is moot there), or
        with ``packed=False`` the chunked lane for prefix caching and for
        contexts longer than ``prefill_chunk`` and one batched dispatch
        per bucket for the rest."""
        for req, _ in admits:
            # the wave's wall lands in each rider's "prefill" clock
            advance_phase(req, "prefill")
        if self._packed:
            self._admit_packed(admits)
            return
        buckets: Dict[int, List] = {}
        for req, ctx in admits:
            L = len(ctx)
            if self.enable_prefix_caching or (
                    self.prefill_chunk is not None
                    and L > self.prefill_chunk):
                self._admit_chunked(req, ctx)
                continue
            Lp = -(-L // self.prefill_bucket) * self.prefill_bucket
            buckets.setdefault(Lp, []).append((req, ctx))
        for group in buckets.values():
            self._admit_batch(group)

    def _first_tokens(self, x, rows, last):
        """Sample the first token of each admitted context from ``x``'s
        hidden state at (``rows``, ``last``): one shared logits tail and
        one host read for the wave."""
        dev = self.device
        h = _rms_norm(x[torch.as_tensor(rows, device=dev),
                        torch.as_tensor(last, device=dev)],
                      self.params["final_norm"], self.cfg.rms_norm_eps)
        logits = _mm(h, self.params["lm_head"], self.cfg.dtype).float()
        return _pick_token(logits, self.temperature, self._gen, self.top_k,
                           self.top_p).cpu().numpy()

    def _emit_first(self, plan_reqs, slots, toks_out) -> None:
        """Bookkeeping of an admitted wave: a fresh request takes its
        sampled first token, a resumed one its saved next input."""
        for i, (req, slot) in enumerate(zip(plan_reqs, slots)):
            if req.generated:                    # resume after preempt
                tok = req.generated[-1]
            else:
                tok = int(toks_out[i])
                req.generated.append(tok)
                self._stream.append((req.rid, tok))
            self._finish_admit(req, slot, tok)

    def _admit_batch(self, group: List) -> None:
        """Batched admission: K same-bucket contexts prefill as one dense
        ``[K_pow2, bucket]`` dispatch of :func:`_prefill` and one batched
        page write.  A fresh request samples its first token from its
        last real position; a preempted one resumes at its saved token."""
        reqs = [r for r, _ in group]
        ctxs = [c for _, c in group]
        K = len(reqs)
        Ls = [len(c) for c in ctxs]
        Lp = -(-max(Ls) // self.prefill_bucket) * self.prefill_bucket
        # a power-of-two batch: padding rows are ignored
        Kp = 1 << (K - 1).bit_length()
        slots = []
        for L in Ls:
            slot = self._free_slots.pop()
            self.cache.alloc_row(slot, L)
            slots.append(slot)
        padded = np.zeros((Kp, Lp), np.int64)
        for i, ctx in enumerate(ctxs):
            padded[i, :Ls[i]] = ctx
        faults.fire("prefill_dispatch")
        x, ks, vs = self._prefill_dense(
            self.params, torch.from_numpy(padded).to(self.device))
        self.prefill_calls += 1
        waste = Kp * Lp - sum(Ls)
        self.prefill_token_slots += Kp * Lp
        self.prefill_padded_tokens += waste
        if self.metrics is not None:
            self.metrics.prefill_dispatches.inc()
            self.metrics.prefill_padded_tokens.inc(waste)
        self.cache.write_pages_batch(
            [(slot, ks[:, i], vs[:, i], L, 0)
             for i, (slot, L) in enumerate(zip(slots, Ls))])
        toks_out = None
        if any(not r.generated for r in reqs):
            # skipped for an all-resume group: their tokens are saved
            toks_out = self._first_tokens(
                x, list(range(K)), [L - 1 for L in Ls])
        self._emit_first(reqs, slots, toks_out)

    def _admit_chunked(self, req: Request, ctx: np.ndarray) -> None:
        """Chunked admission, for a context longer than ``prefill_chunk``
        and, with prefix caching, for every admission (a reused prefix
        starts the row mid-context): the context advances chunk by chunk
        through :func:`_prefill_chunk` over the row's cached pages, so a
        dispatch costs one chunk, and cached prefix pages are never
        computed again.  With prefix caching the prompt's full pages are
        registered afterwards (generated tokens stay private)."""
        L = len(ctx)
        chunk = self.prefill_chunk or self.prefill_bucket
        cache = self.cache
        page = cache.page
        dev = self.device
        slot = self._free_slots.pop()
        if self.enable_prefix_caching:
            start = cache.alloc_row_prefix(slot, ctx)
        else:
            cache.alloc_row(slot, L)
            start = 0
        q8 = cache.kv_quant == "int8"
        x = None
        pos = start
        nchunks = 0
        last_real = 0
        while pos < L:
            C_real = min(chunk, L - pos)
            toks = np.zeros((1, chunk), np.int64)
            toks[0, :C_real] = ctx[pos:pos + C_real]
            table = torch.from_numpy(cache.tables[slot].copy()).to(dev)
            faults.fire("prefill_dispatch")
            x, ks, vs = self._prefill_chunked(
                self.params, torch.from_numpy(toks).to(dev), cache.kpool,
                cache.vpool, cache.kscale if q8 else None,
                cache.vscale if q8 else None, table, pos)
            self.prefill_calls += 1
            nchunks += 1
            cache.write_row_pages(slot, ks, vs, C_real,
                                  first_page=pos // page)
            last_real = C_real
            pos += C_real
        waste = nchunks * chunk - (L - start)
        self.prefill_token_slots += nchunks * chunk
        self.prefill_padded_tokens += waste
        if self.metrics is not None and nchunks:
            self.metrics.prefill_dispatches.inc(nchunks)
            self.metrics.prefill_chunks.inc(nchunks)
            self.metrics.prefill_padded_tokens.inc(waste)
        toks_out = None
        if not req.generated:
            toks_out = self._first_tokens(x, [0], [last_real - 1])
        if self.enable_prefix_caching:
            cache.register_prefix(slot, req.prompt)
        self._emit_first([req], [slot], toks_out)

    def _packed_bucket(self, T: int) -> int:
        """Round a packed-stream length up to a power-of-two number of
        prefill buckets."""
        n = -(-T // self.prefill_bucket)
        return self.prefill_bucket * (1 << (n - 1).bit_length())

    def _admit_packed(self, group: List) -> None:
        """Packed varlen admission: every context of the wave (fresh
        prompts, prefix-cache suffixes and preemption resumes) packs into
        one ``[T_bucket]`` token stream with segment ids and prefills as
        one pass; each segment's K/V lands in its row's pages through one
        batched page write, and each fresh segment's last real position
        feeds one shared logits tail for its first token.

        With prefix caching each row shares its cached prefix pages
        (``alloc_row_prefix``) and registers its prompt's pages before the
        next segment allocates, so equal prefixes share within one wave;
        a shared page's slots carry history: from the pool, or from the
        stream where this wave itself writes the page (``wave_src``)."""
        cache = self.cache
        page = cache.page
        dev = self.device
        prefix = self.enable_prefix_caching
        K = len(group)
        plan = []           # (req, ctx, slot, start, s_real, Wp, off)
        # page id -> stream index of its first token, for pages this wave
        # writes (a same-wave sharer reads them from the stream: their pool
        # copy lands only after the pass)
        wave_src: Dict[int, int] = {}
        T = 0
        for req, ctx in group:
            slot = self._free_slots.pop()
            L = len(ctx)
            if prefix:
                start = cache.alloc_row_prefix(slot, ctx)
            else:
                cache.alloc_row(slot, L)
                start = 0
            s_real = L - start
            Wp = -(-s_real // page) * page   # page-pad the suffix
            plan.append((req, ctx, slot, start, s_real, Wp, T))
            for j in range(start // page, (start + Wp) // page):
                wave_src[int(cache.tables[slot, j])] = T + j * page
            T += start + Wp
            if prefix:
                cache.register_prefix(slot, req.prompt)
        Tb = self._packed_bucket(T)
        toks = np.zeros((1, Tb), np.int64)
        seg = np.full((1, Tb), K, np.int32)      # sentinel tail id
        pos = np.zeros((1, Tb), np.int32)
        hist = [np.zeros((Tb,), np.int32), np.zeros((Tb,), np.int32),
                np.zeros((Tb,), bool), np.zeros((Tb,), np.int32),
                np.zeros((Tb,), bool)]
        hist_page, hist_slot, pool_hist, stream_src, stream_hist = hist
        for i, (req, ctx, slot, start, s_real, Wp, off) in enumerate(plan):
            W = start + Wp
            seg[0, off:off + W] = i
            pos[0, off:off + W] = np.arange(W)
            toks[0, off + start:off + start + s_real] = ctx[start:]
            for j in range(start // page):       # reused prefix pages
                pid = int(cache.tables[slot, j])
                a = off + j * page
                src = wave_src.get(pid)
                if src is not None and src < off:
                    stream_src[a:a + page] = src + np.arange(page)
                    stream_hist[a:a + page] = True
                else:
                    hist_page[a:a + page] = pid
                    hist_slot[a:a + page] = np.arange(page)
                    pool_hist[a:a + page] = True
        extra = ()
        if prefix:
            pools = (cache.kpool, cache.vpool, cache.kscale, cache.vscale)
            extra = pools + tuple(torch.from_numpy(a).to(dev) for a in hist)
        faults.fire("prefill_dispatch")
        x, ks, vs = self._prefill_packed(
            self.params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev),
            *extra)
        self.prefill_calls += 1
        real = sum(p[3] + p[4] for p in plan)
        self.prefill_token_slots += Tb
        self.prefill_padded_tokens += Tb - real
        if self.metrics is not None:
            self.metrics.prefill_dispatches.inc()
            self.metrics.prefill_padded_tokens.inc(Tb - real)
            self.metrics.prefill_packed_tokens.observe(Tb)
        cache.write_pages_batch(
            [(slot, ks[:, off + start:off + start + Wp],
              vs[:, off + start:off + start + Wp], s_real, start // page)
             for _, _, slot, start, s_real, Wp, off in plan])
        toks_out = None
        if any(not p[0].generated for p in plan):
            # first tokens from each segment's LAST real position
            # (skipped for an all-resume wave: their tokens are saved)
            toks_out = self._first_tokens(
                x, [0] * K, [off + start + s_real - 1
                             for _, _, _, start, s_real, _, off in plan])
        self._emit_first([p[0] for p in plan], [p[2] for p in plan],
                         toks_out)

    # -- the mixed prefill + decode lane ----------------------------------
    def _mixed_carve(self) -> None:
        """Mixed-lane admission: claim a slot and the row's pages for each
        waiting request that fits and park it as chunk state in
        ``_mixed_pref`` (no prefill dispatch here; its context rides inside
        the next mixed ticks).  A swapped-out request restores through the
        ordinary zero-prefill path (``_admit_swapped``, the pipeline flushed
        first on the overlap lane).  A context longer than ``mixed_ctx_cap``
        does not fit the mixed stream and admits through one sequential
        packed wave (counted in ``mixed_degraded``).  The queue is
        class-ordered and a head that finds no seat priority-preempts, as in
        ``_admit_wave``: a deliberate departure from JAX's carve, which
        waits for a seat."""
        cache = self.cache
        self._order_queue()
        while self._has_priorities and self._queue and not (
                self._free_slots and self._pages_needed(self._queue[0])
                <= cache.available_pages()) and self._priority_preempt():
            # as in _admit_wave, until the head finds a slot and its
            # pages; the victim went back to the head
            self._order_queue()
        degrades: List = []
        res_pages = 0
        while self._queue:
            if len(self._free_slots) <= len(degrades):
                break                 # keep a slot per pending degrade
            head = self._queue[0]
            need = self._pages_needed(head)
            if need + res_pages > cache.available_pages():
                break
            if head.rid in self._swap_handles:
                if self.overlap:
                    self._pipeline_flush()
                req = self._queue.popleft()
                self._admitting.append(req)
                if not self._admit_swapped(req):
                    # record dropped: back to the head for a recompute
                    # admission through the carve
                    self._queue.appendleft(req)
                self._admitting = []
                continue
            ctx = self._ctx_of(head)
            if len(ctx) > self.mixed_ctx_cap:
                degrades.append((self._queue.popleft(), ctx))
                res_pages += need
                continue
            slot = self._free_slots.pop()
            try:
                if self.enable_prefix_caching:
                    start = cache.alloc_row_prefix(slot, ctx)
                else:
                    cache.alloc_row(slot, len(ctx))
                    start = 0
            except RuntimeError:
                # out of pages (eviction could not cover): the request
                # stays queued for a later tick
                self._free_slots.append(slot)
                break
            req = self._queue.popleft()
            if req.generated:             # recompute-style resume
                self.resumes_recompute += 1
                if self.metrics is not None:
                    self.metrics.preempt_resume_recompute.inc()
            # parked mid-prefill: "prefill" until activation
            advance_phase(req, "prefill")
            self._mixed_pref[slot] = {"req": req, "ctx": ctx, "pos": start,
                                      "start": start}
        if degrades:
            self.mixed_degraded += len(degrades)
            if self.overlap:
                self._pipeline_flush()
            self._admitting = [r for r, _ in degrades]
            self._admit_sequential(degrades)
            self._admitting = []

    def _mixed_plan(self) -> List:
        """This tick's prefill budget carved across the parked rows (FIFO by
        carve order): each takes up to the budget pages left, bounded by
        the stream room left after its history slots (a resumed chunk
        gathers its written context into the stream).  -> ``(slot, pos,
        take, npg)`` tuples, page-aligned.  The budget bounds only the
        piggybacked prefill; decode rows are never throttled."""
        page = self.cache.page
        budget_pg = self.mixed_token_budget // page
        stream_pg = self.mixed_ctx_cap // page
        plan: List = []
        for slot, ent in self._mixed_pref.items():
            if budget_pg <= 0 or stream_pg <= 0:
                break
            pos = ent["pos"]
            rem = len(ent["ctx"]) - pos
            hist_pg = pos // page
            fit = stream_pg - hist_pg
            if fit <= 0:
                continue          # waits for a roomier tick
            npg = min(-(-rem // page), budget_pg, fit)
            if npg <= 0:
                continue
            take = min(rem, npg * page)
            plan.append((slot, pos, take, npg))
            budget_pg -= npg
            stream_pg -= hist_pg + npg
        return plan

    def _stage_upload(self, stage: Dict, arrays):
        """Pack ``arrays`` (host ints and bools) into ``stage``'s pinned
        int32 buffer and send them up as one non-blocking copy, an event
        behind it -> int32 device views, in order.  The buffer is rewritten
        only after the step that read it drained."""
        buf = stage["buf"]
        n = sum(a.size for a in arrays)
        host = buf.numpy()
        off = 0
        for a in arrays:
            host[off:off + a.size] = a.reshape(-1)
            off += a.size
        dev = buf[:n].to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            stage["event"] = torch.cuda.Event()
            stage["event"].record(torch.cuda.current_stream(self.device))
        views, off = [], 0
        for a in arrays:
            views.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return views

    def _decode_mixed(self) -> None:
        """One mixed tick: a single call of :func:`make_mixed_step`
        advances every active decode row and prefills up to
        ``mixed_token_budget`` tokens of the parked rows.  Completing
        segments sample their first token in the call and activate on the
        device; the overlap lane chains the next dispatch off the graph's
        state tensors (the tick writes its outputs there) and learns the
        first tokens at the ordinary drain, in the same ``_fetch`` as the
        decode outputs; the synchronous lane fetches once a tick.  The
        stream's host arrays go up as one pinned non-blocking copy."""
        cache = self.cache
        page = cache.page
        B = self.B
        if self.overlap:
            if self._dev is not None and self._dev is not self._graph():
                # a flag flip changed the key: start from host truth
                self._needs_flush = True
            if self._needs_flush:
                self._pipeline_flush()
        if self._active:
            self._ensure_or_preempt()
            if self.overlap and self._needs_flush:   # a preemption landed
                self._pipeline_flush()
        plan = self._mixed_plan()
        if not plan:
            # the growth pass preempted every parked row: nothing to
            # piggyback, so the plain decode tick runs
            self._decode_once()
            return
        # the packed lane's layout: each segment is [history slots][fresh
        # chunk, page-padded], then the sentinel tail
        T = sum((pos // page + npg) * page for _, pos, _, npg in plan)
        Tb = self._packed_bucket(max(T, page))
        nseg = len(plan)
        toks = np.zeros((1, Tb), np.int32)
        seg = np.full((1, Tb), nseg, np.int32)
        posa = np.zeros((1, Tb), np.int32)
        hist_page = np.zeros((Tb,), np.int32)
        hist_slot = np.zeros((Tb,), np.int32)
        pool_hist = np.zeros((Tb,), np.int32)
        dest_page = np.zeros((Tb,), np.int32)
        dest_slot = np.zeros((Tb,), np.int32)
        sample_idx = np.zeros((B,), np.int32)
        activate = np.zeros((B,), bool)
        p_first = np.zeros((B,), np.int32)
        p_sample = np.zeros((B,), np.int32)
        p_len = np.zeros((B,), np.int32)
        p_rem = np.zeros((B,), np.int32)
        off = 0
        fresh = 0
        hist_total = 0
        completing: List = []
        for i, (slot, pos, take, npg) in enumerate(plan):
            ent = self._mixed_pref[slot]
            W = pos + npg * page
            seg[0, off:off + W] = i
            posa[0, off:off + W] = np.arange(W)
            toks[0, off + pos:off + pos + take] = ent["ctx"][pos:pos + take]
            for j in range(pos // page):
                a = off + j * page
                hist_page[a:a + page] = cache.tables[slot, j]
                hist_slot[a:a + page] = np.arange(page)
                pool_hist[a:a + page] = 1
            for j in range(npg):
                a = off + pos + j * page
                dest_page[a:a + page] = cache.tables[slot, pos // page + j]
                dest_slot[a:a + page] = np.arange(page)
            fresh += take
            hist_total += pos
            if pos + take == len(ent["ctx"]):
                req = ent["req"]
                activate[slot] = True
                p_len[slot] = len(ent["ctx"])
                if req.generated:        # resume: its saved next input
                    p_first[slot] = req.generated[-1]
                    p_rem[slot] = req.max_new_tokens - len(req.generated)
                else:                    # fresh: sampled in the call
                    p_sample[slot] = 1
                    sample_idx[slot] = off + pos + take - 1
                    p_rem[slot] = req.max_new_tokens - 1
                completing.append((slot, req))
            off += W
        stream = [toks, seg, posa, hist_page, hist_slot, pool_hist,
                  dest_page, dest_slot, sample_idx, activate.astype(np.int32),
                  p_first, p_sample, p_len, p_rem]
        # before any ring slot, staging buffer, upload or call
        faults.fire("step_dispatch")
        if self.overlap:
            slot_h = self._ring[self._ring_i % len(self._ring)]
            self._ring_i += 1
            g = self._seed_or_refresh_dev(slot_h)
            views = self._stage_upload(slot_h["stage"], stream)
            state = (g.tables, g.lens, g.tok, g.active, g.remaining, g.eos)
        else:
            views = self._stage_upload(self._mixed_stage, stream + [
                cache.tables, cache.lens, self._next_tok.astype(np.int32),
                self._active_mask, self._remaining.astype(np.int32)])
            state = (*views[len(stream):], self._eos_dev)
            views = views[:len(stream)]
        *_, nxt, lens2, rem2, act2, done, ftok = self._step_mixed(
            self.params, *self._pools(), *state, self._gen, *views)
        self.decode_steps += 1
        self.mixed_ticks += 1
        self.mixed_prefill_tokens += fresh
        self.prefill_token_slots += Tb
        padded = Tb - hist_total - fresh
        self.prefill_padded_tokens += padded
        if self.metrics is not None:
            m = self.metrics
            m.decode_steps.inc()
            m.mixed_ticks.inc()
            m.mixed_prefill_tokens.inc(fresh)
            m.mixed_budget_tokens.observe(fresh)
            m.prefill_padded_tokens.inc(padded)
        # the host lens mirror before activation: an activated row's first
        # decode write lands next dispatch at p_len (its alloc set lens)
        cache.lens = cache.lens + self._active_mask
        if self.overlap:
            # the next dispatch (a replay or a mixed tick) chains off the
            # graph's state tensors
            g.tok.copy_(nxt)
            g.lens.copy_(lens2)
            g.remaining.copy_(rem2)
            g.active.copy_(act2)
            slot_h["out"][:, 0].copy_(
                torch.stack([nxt, done.to(nxt.dtype), ftok.to(nxt.dtype)]),
                non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            entry: Dict = {"out": slot_h["out"], "event": event}
            if completing:
                entry["activate"] = activate.copy()
                entry["mixed_first"] = {s: r for s, r in completing
                                        if not r.generated}
            self._inflight.append(entry)
        # the chunk state advances; a prefix page registers only after the
        # dispatch that wrote it (later sharers gather it from the pool)
        for slot, pos, take, npg in plan:
            ent = self._mixed_pref.get(slot)
            if ent is None:
                continue
            req = ent["req"]
            ent["pos"] = pos + take if pos + take == len(ent["ctx"]) \
                else pos + npg * page
            if self.enable_prefix_caching:
                written = min(pos + take, len(req.prompt))
                if written >= page:
                    cache.register_prefix(slot,
                                          np.asarray(req.prompt[:written]))
        # activation: completing rows join the decode batch for the next
        # dispatch (the device state already carries them); a fresh row's
        # first token surfaces at the fetch
        for slot, req in completing:
            if self._mixed_pref.pop(slot, None) is None:
                continue
            if req.t_admit == 0.0:
                req.t_admit = time.monotonic()
                if self.metrics is not None:
                    self.metrics.queue_wait.observe(
                        req.t_admit - req.t_submit, exemplar=_tid(req))
            advance_phase(req, "decode_active")
            req.slot = slot
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self._active[slot] = req
            self._active_mask[slot] = 1
            self._remaining[slot] = int(p_rem[slot])
            if req.generated:            # resume: its token is known
                self._next_tok[slot] = req.generated[-1]
                if self._hit_stop(req, req.generated[-1]) or \
                        self._remaining[slot] <= 0:
                    # a host-only retirement under an in-flight dispatch,
                    # as a stop sequence
                    self._retire(slot)
                    if self.overlap:
                        self._needs_flush = True
        if self.overlap:
            if len(self._inflight) > self.lookahead:
                self._drain_one()
            return
        # the synchronous lane: one fetch a tick
        (out_h,) = self._fetch(None, torch.stack([nxt, ftok.to(nxt.dtype)]))
        nxt_h, ftok_h = out_h
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        advanced = 0
        for slot, req in list(self._active.items()):
            if activate[slot]:
                continue       # its first decode token comes next tick
            t = int(nxt_h[slot])
            self._deliver_token(slot, req, t)
            advanced += 1
            self._remaining[slot] -= 1
            if self._hit_stop(req, t) or self._remaining[slot] <= 0:
                self._retire(slot)
        for slot, req in completing:
            if req.generated or self._active.get(slot) is not req:
                continue
            t = int(ftok_h[slot])
            self._deliver_token(slot, req, t, count=False)
            if self._hit_stop(req, t) or self._remaining[slot] <= 0:
                self._retire(slot)
        if self.metrics is not None:
            self.metrics.tokens_generated.inc(advanced)
            self.metrics.host_bookkeeping.observe(time.perf_counter() - t0)

    def _preempt(self, keep: Optional[int],
                 only: Optional[List[int]] = None) -> bool:
        """Evict one active request (except slot ``keep``; among ``only``
        when given, the priority path's lower-class slots) and requeue it
        at the FRONT of the queue.  The policy picks the victim: the lowest
        class, the most recently admitted within it.  With a host tier and
        a cost model that favours it (``_preempt_mode``) its private pages
        swap out (the resume restores them, zero prefill); otherwise, or
        when the swap-out is refused, its pages are released
        (recompute-style: the resume re-prefills prompt + generated).
        Returns False when there is no victim.

        Rows parked mid-prefill on the mixed lane go first (the youngest
        carve first): they are the youngest page holders and have produced
        nothing, and without this a carve could leave an active row's
        growth with no victim.  The pipeline is drained when this runs, so
        a parked row's half-written pages are safe to free."""
        if self._mixed_pref and only is None:
            slot = next(reversed(self._mixed_pref))
            req = self._mixed_pref.pop(slot)["req"]
            req.slot = None
            req.preempted += 1
            self.preemptions += 1
            advance_phase(req, "preempted")
            if req.trace is not None:
                req.trace.event("preempt", mode="mixed-parked", slot=slot)
            self._free_slot(slot)
            self._queue.appendleft(req)
            if self.metrics is not None:
                self.metrics.preemptions.inc()
                self.metrics.ring.emit("preemption", rid=req.rid, slot=slot,
                                       mode="mixed-parked",
                                       generated=len(req.generated))
            return True
        victims = [s for s in (self._active if only is None else only)
                   if s != keep and s in self._active]
        if not victims:
            return False
        slot = self.policy.select_victim(victims, self._active)
        mode = self._preempt_mode(slot)
        req = self._active.pop(slot)
        req.slot = None
        req.preempted += 1
        self.preemptions += 1
        if mode == "swap":
            t0 = time.perf_counter()
            try:
                self._swap_handles[req.rid] = self.cache.swap_out_row(slot)
            except RuntimeError:
                # refused before any change (the host tier raced full, or
                # an injected fault): recompute-style preemption instead
                mode = "recompute"
                self._release_slot(slot)
            else:
                # the main row is parked; the speculative state is rebuilt
                # at the resume
                self._release_aux(slot)
                if self.metrics is not None:
                    self.metrics.swap_seconds.observe(
                        time.perf_counter() - t0)
        else:
            self._release_slot(slot)
        self._free_slots.append(slot)
        self._remaining[slot] = 0
        self._active_mask[slot] = 0
        # a scheduler mutation point: the decode loop never touches the
        # phase clocks.  "swapped": parked in the host tier (a restore
        # pending); "preempted": a recompute requeue
        advance_phase(req, "swapped" if mode == "swap" else "preempted")
        if req.trace is not None:
            req.trace.event("preempt", mode=mode, slot=slot,
                            generated=len(req.generated))
        if self.metrics is not None:
            self.metrics.preemptions.inc()
            self.metrics.ring.emit("preemption", rid=req.rid, slot=slot,
                                   mode=mode,
                                   generated=len(req.generated))
        self._queue.appendleft(req)
        if self.overlap:
            # the device's active chain still carries the victim: re-seed
            # the loop state before the next dispatch
            self._needs_flush = True
        return True

    def _grow_tokens(self, slot: int, new_tokens: int) -> int:
        """How many tokens of pages this dispatch must claim for ``slot``.
        A horizon claim is clamped to the row's remaining budget (the
        block stops advancing at 0) and to its table capacity (the lens
        mirror of a row that retired on the device but is not drained yet
        over-advances).  A single-step claim passes through, except for
        such a row past its table.  A speculative claim (gamma + 1) has no
        budget clamp: the round scatters every candidate's K/V, past the
        budget too, and clamping it would push real verify writes onto the
        junk page; only the table's capacity clamps it.  ``<= 0``: nothing
        to claim."""
        lens_m = int(self.cache.lens[slot])
        if self._spec is not None:
            return min(new_tokens,
                       self.cache.pages_max * self.cache.page - lens_m)
        if self.decode_horizon == 1:
            if self._inflight and \
                    lens_m // self.cache.page >= self.cache.pages_max:
                return 0
            return new_tokens
        cap = self.cache.pages_max * self.cache.page - lens_m
        return min(new_tokens, max(int(self._remaining[slot]), 1), cap)

    def _ensure_or_preempt(self, new_tokens: int = 1, aux_cache=None,
                           aux_new: int = 0, aux_rows=None) -> None:
        """Grow every active row by ``new_tokens`` of pages as one
        coalesced claim (at most one ``tables_version`` bump, so at most
        one device tables re-upload), falling back under pool pressure to
        a per-slot loop that flushes the pipeline first while dispatches
        are in flight and then preempts the youngest other request.

        ``aux_cache`` (the draft cache) grows by ``aux_new`` tokens on the
        same rows, restricted to ``aux_rows`` (the spec-on rows: a spec-off
        row owns no draft row, and a claim for it would leak draft
        pages)."""
        needs = []
        for slot in self._active:
            n = self._grow_tokens(slot, new_tokens)
            if n > 0:
                needs.append((slot, n))
        if not needs:
            return
        try:
            self.cache.ensure_capacity_batch(needs)
            if aux_cache is not None:
                aux_needs = [(slot, aux_new) for slot, _ in needs
                             if aux_rows is None or aux_rows[slot]]
                if aux_needs:
                    aux_cache.ensure_capacity_batch(aux_needs)
            return
        except RuntimeError:
            pass                   # pool pressure: per-slot fallback
        for slot in list(self._active):
            if slot not in self._active:     # evicted by an earlier turn
                continue
            n = self._grow_tokens(slot, new_tokens)
            if n <= 0:
                continue
            while True:
                try:
                    self.cache.ensure_capacity(slot, n)
                    if aux_cache is not None and \
                            (aux_rows is None or aux_rows[slot]):
                        aux_cache.ensure_capacity(slot, aux_new)
                    break
                except RuntimeError:
                    if self._inflight:
                        # drain first: a pending retirement on the device
                        # may free pages without preempting anyone, and a
                        # victim's pages must not move under in-flight
                        # writes
                        self._pipeline_flush()
                        if slot not in self._active:
                            break
                        n = self._grow_tokens(slot, new_tokens)
                        if n <= 0:
                            break
                        continue
                    if not self._preempt(keep=slot):
                        # no victim left: parked swap records may still
                        # hold shared-page refs; degrade them to recompute
                        # resumes before giving up
                        if self._degrade_one_swap():
                            continue
                        raise RuntimeError(
                            "KV page pool exhausted and no preemption "
                            "victim remains; the pool is too small for a "
                            "single request of this length")

    def _deliver_token(self, slot: int, req: Request, t: int,
                       count: bool = True) -> None:
        """The per-token emission core every lane shares: append, count,
        stream, next input.  ``count=False`` for a mixed tick's first
        tokens (no lane counts an admission's first token in
        ``tokens_generated``).  The budget and the retire decision stay
        with the callers."""
        req.generated.append(t)
        if count:
            self.tokens_generated += 1
        self._note_first_token(req)
        self._stream.append((req.rid, t))
        self._next_tok[slot] = t

    def _decode_once(self) -> None:
        """One decode round for every active slot: the synchronous lane,
        one turn of the dispatch-ahead pipeline (``overlap=True``) or, with
        ``decode_horizon > 1`` and no overlap, one synchronous H-token
        block.  With ``spec=SpecConfig(...)`` every round is one
        speculative call: on the overlap lane for a draft model, else
        synchronous (a prompt-lookup proposal needs the round's committed
        tokens first, so it cannot run ahead of the drain)."""
        if self._spec is not None:
            if self.overlap and self._spec.source == "draft":
                self._decode_spec_overlap()
            else:
                self._decode_spec_sync()
        elif self.overlap:
            self._decode_overlap()
        elif self.decode_horizon > 1:
            self._decode_sync_multi()
        else:
            self._decode_sync()

    def _decode_sync(self) -> None:
        """One eager decode step for the whole batch + a blocking fetch."""
        cache = self.cache
        dev = self.device
        self._ensure_or_preempt()
        tables = torch.from_numpy(cache.tables.copy()).to(dev)
        lens = torch.from_numpy(cache.lens.copy()).to(dev)
        tok = torch.from_numpy(self._next_tok.copy()).to(dev)
        # before the pools are reassigned: a fault never leaves the cache
        # holding half a step's pools
        faults.fire("step_dispatch")
        if cache.kv_quant == "int8":
            (cache.kpool, cache.vpool, cache.kscale, cache.vscale,
             nxt) = self._step(self.params, cache.kpool, cache.vpool,
                               cache.kscale, cache.vscale, tables, lens, tok,
                               self._gen)
        else:
            cache.kpool, cache.vpool, nxt = self._step(
                self.params, cache.kpool, cache.vpool, tables, lens, tok,
                self._gen)
        cache.lens = cache.lens + self._active_mask
        self.decode_steps += 1
        (nxt,) = self._fetch(None, nxt)
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        advanced = 0
        for slot, req in list(self._active.items()):
            t = int(nxt[slot])
            self._deliver_token(slot, req, t)
            advanced += 1
            self._remaining[slot] -= 1
            if self._hit_stop(req, t) or self._remaining[slot] <= 0:
                self._retire(slot)
        if self.metrics is not None:
            self.metrics.decode_steps.inc()
            self.metrics.tokens_generated.inc(advanced)
            self.metrics.host_bookkeeping.observe(time.perf_counter() - t0)

    # -- the dispatch-ahead pipeline and the horizon ----------------------
    def _pools(self):
        c = self.cache
        if c.kv_quant == "int8":
            return (c.kpool, c.vpool, c.kscale, c.vscale)
        return (c.kpool, c.vpool)

    def _graph(self):
        """The async (H = 1) or horizon step of the current key."""
        return graphed_step.decode_graph(
            self.cfg, self.decode_horizon, self.decode_horizon > 1,
            self.temperature, self.cache.kv_quant, self.top_k, self.top_p,
            self.params, self._pools(), self.B, self.cache.pages_max,
            self.device, self._gen)

    def _decode_overlap(self) -> None:
        """One turn of the pipeline: dispatch step k chained off step
        k-1's outputs on the device (no host sync), then drain the oldest
        step while k runs."""
        if self._dev is not None and self._dev is not self._graph():
            # a flag flip changed the key: the new graph starts from host
            # truth
            self._needs_flush = True
        if self._needs_flush:
            self._pipeline_flush()
        if self._active:
            # claim pages for the next write positions, the whole
            # horizon's worth, so the tables stay constant across a block
            self._ensure_or_preempt(self.decode_horizon)
            if self._needs_flush:          # a preemption landed
                self._pipeline_flush()
            if self._active:
                self._dispatch_async()
        if self._active and len(self._inflight) > self.lookahead:
            self._drain_one()
        if not self._active and self._inflight:
            # the batch went idle: drain the lookahead dispatches (they
            # carry no live row) so the engine parks with nothing in flight
            while self._inflight:
                self._drain_one()
            self._dev = None

    def _seed_or_refresh_dev(self, slot: Dict):
        """(Re)seed the graph's device-resident loop state from host truth
        after a flush, or re-upload only the tables when page allocations
        bumped ``tables_version`` (on the speculative lane also the draft
        cache's tables when its ``tables_version`` moved).  Every upload
        goes from the pinned ``slot`` with ``non_blocking=True``."""
        cache = self.cache
        spec = self._spec is not None
        g = self._spec_graph().state if spec else self._graph()
        if self._dev is None:
            srcs = [("lens", cache.lens), ("tok", self._next_tok),
                    ("active", self._active_mask.astype(bool)),
                    ("remaining", self._remaining)]
            if spec:
                # the speculative chain also carries the draft catch-up
                # feed and the on / off mask (constant between flushes:
                # admission and retirement both flush)
                srcs += [("prev", self._prev_tok), ("spec_on", self._spec_on)]
                self._dev_dtables_version = -1
            for name, src in srcs:
                slot[name].numpy()[...] = src
                getattr(g, name).copy_(slot[name], non_blocking=True)
            g.eos.copy_(self._eos_dev)
            self._dev = g
            self._dev_tables_version = -1
            self._drain_active = self._active_mask.astype(bool)
        if self._dev_tables_version != cache.tables_version:
            slot["tables"].numpy()[...] = cache.tables
            g.tables.copy_(slot["tables"], non_blocking=True)
            self._dev_tables_version = cache.tables_version
        if spec and self._dev_dtables_version != \
                self._spec_dcache.tables_version:
            slot["dtables"].numpy()[...] = self._spec_dcache.tables
            g.dtables.copy_(slot["dtables"], non_blocking=True)
            self._dev_dtables_version = self._spec_dcache.tables_version
        return g

    def _launch(self) -> Dict:
        """Seed or refresh the state, replay the graph (one step, or one
        H-token block) and queue its outputs' copy into the next pinned
        slot behind it, with an event -> the in-flight entry.  The fault
        site comes first: before the ring slot is taken, any state upload,
        and any graph capture or replay."""
        faults.fire("step_dispatch")
        slot = self._ring[self._ring_i % len(self._ring)]
        self._ring_i += 1
        g = self._seed_or_refresh_dev(slot)
        out = g(self.params, self._pools(), self._gen)
        slot["out"][:2].copy_(out, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self.decode_steps += 1
        if self.metrics is not None:
            self.metrics.decode_steps.inc()
        return {"out": slot["out"], "event": event}

    def _dispatch_async(self) -> None:
        """Issue one step, or one H-micro-step block, chained off the
        device-resident loop state.  No blocking host work: uploads happen
        only after a flush or when the tables grew."""
        self._inflight.append(self._launch())
        # the host lens mirror, for the next dispatch's capacity claim:
        # exact for live rows, over for rows that stop inside the step
        # (their release zeroes it)
        self.cache.lens = self.cache.lens + (self.decode_horizon
                                             * self._active_mask)

    def _fetch(self, event, *arrs):
        """Blocking device->host fetch, the pipeline's one sync point: one
        call per drained step (tests count calls through this seam).
        ``arrs`` are pinned host slots whose copies ``event`` follows, or
        (the synchronous lane) device tensors."""
        self.host_syncs += 1
        if event is not None:
            event.synchronize()
        return [a.numpy() if a.device.type == "cpu" else a.cpu().numpy()
                for a in arrs]

    def _drain_one(self) -> None:
        """Sync on the oldest in-flight step (the next one already runs)
        and do its host bookkeeping: streaming and retirement.  A stop
        sequence is visible only here: it retires the request and
        schedules a flush, since the device's active chain cannot know."""
        e = self._inflight.pop(0)
        if "spec_out" in e:                  # a speculative round
            self._drain_spec_entry(e)
            return
        # a mixed tick's first tokens ride the same fetch
        first = e.get("mixed_first")
        toks, dones, *ftok = self._fetch(
            e["event"], *e["out"][:3 if first is not None else 2])
        if self.decode_horizon > 1:
            self._drain_active = self._drain_horizon_block(
                toks, dones, self._drain_active)
            return
        nxt, done = toks[0], dones[0].astype(bool)
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        mask = self._drain_active
        advanced = 0
        for slot in np.nonzero(mask)[0]:
            slot = int(slot)
            req = self._active.get(slot)
            if req is None:
                # retired on the host (stop sequence) after this step was
                # dispatched: its token is dead, and the scheduled flush
                # keeps the slot from being reused under it
                continue
            t = int(nxt[slot])
            self._deliver_token(slot, req, t)
            advanced += 1
            self._remaining[slot] -= 1
            if done[slot]:
                self._retire(slot)          # eos / budget (on the device)
            elif self._hit_stop(req, t):
                self._retire(slot)          # stop sequence (host only)
                self._needs_flush = True
        # follow the device's active chain: the next undrained step ran
        # with active & ~done
        self._drain_active = mask & ~done
        for slot, req in (first or {}).items():
            # the first tokens of the segments the mixed tick completed
            # (skipped if a cancel or preemption took the row since: its
            # re-prefill samples again)
            if self._active.get(slot) is not req or req.generated:
                continue
            t = int(ftok[0][0, slot])
            self._deliver_token(slot, req, t, count=False)
            if self._hit_stop(req, t) or self._remaining[slot] <= 0:
                # the first token ended the request: a host-only
                # retirement; the chained dispatch's token dies undelivered
                self._retire(slot)
                self._needs_flush = True
        if "activate" in e:
            # the rows the mixed tick activated are live in every later
            # undrained step
            self._drain_active = self._drain_active | e["activate"]
        if self.metrics is not None:
            self.metrics.tokens_generated.inc(advanced)
            self.metrics.host_bookkeeping.observe(time.perf_counter() - t0)

    def _drain_horizon_block(self, toks, dones, mask):
        """Host bookkeeping of one fetched ``[H, B]`` block, shared by the
        overlap drain and the synchronous horizon lane.  ``mask`` is the
        device-active mask at the block's dispatch; returns the mask after
        it (rows drop at their done on the device; rows retired on the
        host stay until the scheduled flush).  A stop sequence retires its
        row where the H = 1 lane would and discards, and counts, the
        tokens the device generated past it."""
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        H = toks.shape[0]
        advanced = 0
        trimmed = 0
        out_mask = mask.copy()
        for slot in np.nonzero(mask)[0]:
            slot = int(slot)
            nd = np.nonzero(dones[:, slot])[0]
            # the row generated up to and including its first done; after
            # it the column repeats its last token
            n_gen = int(nd[0]) + 1 if nd.size else H
            device_done = nd.size > 0
            if device_done:
                out_mask[slot] = False
            req = self._active.get(slot)
            if req is None:
                continue            # retired on the host: tokens are dead
            col = toks[:, slot]
            if req.stop_sequences:
                for h in range(n_gen):
                    t = int(col[h])
                    self._deliver_token(slot, req, t)
                    advanced += 1
                    self._remaining[slot] -= 1
                    if h == n_gen - 1 and device_done:
                        self._retire(slot)
                    elif self._hit_stop(req, t):
                        self._retire(slot)
                        if self.overlap:
                            self._needs_flush = True
                        trimmed += n_gen - 1 - h
                        break
                continue
            # no stop sequence: the column lands as one bulk extend
            got = col[:n_gen].tolist()
            req.generated.extend(got)
            self.tokens_generated += n_gen
            advanced += n_gen
            self._note_first_token(req)
            self._stream.extend((req.rid, t) for t in got)
            self._next_tok[slot] = got[-1]
            self._remaining[slot] -= n_gen
            if device_done:
                self._retire(slot)
        if trimmed:
            self.horizon_trimmed_tokens += trimmed
            if self.metrics is not None:
                self.metrics.horizon_trimmed_tokens.inc(trimmed)
        if self.metrics is not None:
            self.metrics.tokens_generated.inc(advanced)
            self.metrics.decode_horizon_tokens.observe(advanced)
            self.metrics.host_bookkeeping.observe(time.perf_counter() - t0)
        return out_mask

    def _decode_sync_multi(self) -> None:
        """The synchronous horizon lane: one H-micro-step block seeded
        from host truth, then one blocking fetch."""
        self._ensure_or_preempt(self.decode_horizon)
        self._dev = None             # seed from host truth every block
        e = self._launch()
        self._dev = None
        mask = self._active_mask.astype(bool)
        self.cache.lens = self.cache.lens + (self.decode_horizon
                                             * self._active_mask)
        toks, dones = self._fetch(e["event"], e["out"][0], e["out"][1])
        self._drain_horizon_block(toks, dones, mask)

    # -- the speculative lane (spec=SpecConfig(...)) -----------------------
    def _dpools(self):
        c = self._spec_dcache
        if c.kv_quant == "int8":
            return (c.kpool, c.vpool, c.kscale, c.vscale)
        return (c.kpool, c.vpool)

    def _spec_fused(self):
        """The speculative round for the current gamma
        (:func:`make_spec_step` memoises: an adaptive retune builds one
        function per distinct gamma)."""
        dcache = self._spec_dcache
        return make_spec_step(
            self.cfg, self.gamma, draft_cfg=self._spec_dcfg,
            kv_quant=self.cache.kv_quant,
            draft_kv_quant=dcache.kv_quant if dcache is not None else None)

    def _spec_graph(self):
        """The overlap lane's draft-model round of the current gamma: a
        :class:`~paddle_tpu_torch.models.graphed_step.SpecGraph` over the
        key's shared state."""
        c, dc = self.cache, self._spec_dcache
        return graphed_step.spec_graph(
            self.cfg, self._spec_dcfg, self.gamma, c.kv_quant, dc.kv_quant,
            self.params, self._spec_dparams, self._pools(), self._dpools(),
            self.B, c.pages_max, dc.pages_max, self.device)

    def _propose_lookup(self) -> np.ndarray:
        """Prompt-lookup drafting: match each spec-on row's last ``ngram``
        committed tokens against its own history and propose the
        continuation of the earliest prior occurrence.  A miss proposes
        zeros: the verify rejects them and the row still commits its one
        greedy token."""
        G = self.gamma
        n = self._spec.ngram
        out = np.zeros((self.B, G), np.int64)
        for slot in self._active:
            if not self._spec_on[slot]:
                continue
            seq = self._spec_seq.get(slot)
            if seq is None or len(seq) <= n:
                continue
            idx = self._spec_ngrams[slot].get(tuple(seq[-n:]))
            if idx is None:
                continue
            cand = seq[idx:idx + G]
            out[slot, :len(cand)] = cand
        return out

    def _spec_note_tokens(self, slot: int, toks_list) -> None:
        """Extend a prompt-lookup row's history and n-gram table with the
        round's committed tokens (the first occurrence wins, as at
        admission)."""
        seq = self._spec_seq.get(slot)
        if seq is None:
            return
        tab = self._spec_ngrams[slot]
        n = self._spec.ngram
        start = max(len(seq), n)
        seq.extend(int(t) for t in toks_list)
        for i in range(start, len(seq)):
            tab.setdefault(tuple(seq[i - n:i]), i)

    def _spec_dispatch_args(self, inputs: Dict):
        """The round's positional arguments from a dict of device inputs:
        the one owner of the (draft, q8, draft q8) layout."""
        draft = self._spec.source == "draft"
        args = [self.params]
        if draft:
            args.append(self._spec_dparams)
        args += self._pools()
        if draft:
            args += self._dpools()
        args.append(inputs["tables"])
        if draft:
            args.append(inputs["dtables"])
        args += [inputs["lens"], inputs["tok"],
                 inputs["prev"] if draft else inputs["drafts"],
                 inputs["active"], inputs["remaining"], inputs["spec_on"],
                 self._eos_dev]
        return args

    def _spec_unpack(self, rets):
        """-> (toks, dones, emits, accepts, chain): the pools (updated in
        place) dropped, ``chain`` the round's loop state."""
        n = len(self._pools())
        if self._spec.source == "draft":
            n += len(self._dpools())
        return (*rets[n:n + 4], rets[n + 4:])

    def _decode_spec_sync(self) -> None:
        """One speculative round, synchronous cadence: one eager call (the
        draft model's micro-steps, or the host's prompt-lookup proposals,
        then the verify) and one blocking fetch of up to gamma + 1
        committed tokens a row.  Also an overlap engine's prompt-lookup
        cadence."""
        if self._needs_flush:    # prompt lookup on an overlap engine
            self._pipeline_flush()
        cache, dcache = self.cache, self._spec_dcache
        dev = self.device
        C = self.gamma + 1
        self._ensure_or_preempt(C, aux_cache=dcache, aux_new=C,
                                aux_rows=self._spec_on)
        fused = self._spec_fused()
        mask = self._active_mask.astype(bool)
        spec_rows = mask & self._spec_on
        host = {"tables": cache.tables, "lens": cache.lens,
                "tok": self._next_tok, "active": mask,
                "remaining": self._remaining, "spec_on": self._spec_on}
        if dcache is not None:
            host["dtables"] = dcache.tables
            host["prev"] = self._prev_tok
        else:
            host["drafts"] = self._propose_lookup()
        # before any upload or call
        faults.fire("step_dispatch")
        inputs = {k: torch.from_numpy(a.copy()).to(dev)
                  for k, a in host.items()}
        toks, dones, emits, accs, _ = self._spec_unpack(
            fused(*self._spec_dispatch_args(inputs)))
        # the worst case (C a live row, draft rows too); the drain corrects
        # each row to its commit
        cache.lens = cache.lens + C * self._active_mask
        if dcache is not None:
            dcache.lens = dcache.lens + C * spec_rows.astype(
                dcache.lens.dtype)
        self.decode_steps += 1
        if self.metrics is not None:
            self.metrics.decode_steps.inc()
        toks, dones, emits, accs = self._fetch(None, toks, dones, emits,
                                               accs)
        self._drain_spec_block(toks, dones, emits, accs, mask)

    def _decode_spec_overlap(self) -> None:
        """One turn of the pipeline in speculative form (a draft model):
        round k+1 replays chained off round k's device state (tok', prev',
        lens', remaining', active') and the host drains round k while k+1
        runs."""
        if self._dev is not None and self._dev is not \
                self._spec_graph().state:
            # a flag flip changed the key: start from host truth
            self._needs_flush = True
        if self._needs_flush:
            self._pipeline_flush()
        if self._active:
            self._ensure_or_preempt(self.gamma + 1,
                                    aux_cache=self._spec_dcache,
                                    aux_new=self.gamma + 1,
                                    aux_rows=self._spec_on)
            if self._needs_flush:          # a preemption landed
                self._pipeline_flush()
            if self._active:
                self._dispatch_spec_async()
        if self._active and len(self._inflight) > self.lookahead:
            self._drain_one()
        if not self._active and self._inflight:
            while self._inflight:
                self._drain_one()
            self._dev = None

    def _dispatch_spec_async(self) -> None:
        """Replay one round chained off the device state and queue its
        outputs' copy into the next pinned slot behind it, with an event.
        The fault site comes first: before the ring slot is taken, any
        state upload, and any graph capture or replay."""
        faults.fire("step_dispatch")
        cache, dcache = self.cache, self._spec_dcache
        C = self.gamma + 1
        slot = self._ring[self._ring_i % len(self._ring)]
        self._ring_i += 1
        self._seed_or_refresh_dev(slot)
        out, acc = self._spec_graph()(self.params, self._spec_dparams,
                                      self._pools(), self._dpools())
        host_out = slot["spec_out"][:3 * C * self.B].view(3, C, self.B)
        host_out.copy_(out, non_blocking=True)
        slot["accepts"].copy_(acc, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight.append({"spec_out": host_out,
                               "accepts": slot["accepts"], "event": event})
        # the worst case; each drain corrects its round's rows
        spec_rows = self._active_mask.astype(bool) & self._spec_on
        cache.lens = cache.lens + C * self._active_mask
        dcache.lens = dcache.lens + C * spec_rows.astype(dcache.lens.dtype)
        self.decode_steps += 1
        if self.metrics is not None:
            self.metrics.decode_steps.inc()

    def _drain_spec_entry(self, e: Dict) -> None:
        """Drain one in-flight round: one blocking fetch of its four
        arrays."""
        out = e["spec_out"]
        toks, dones, emits, accs = self._fetch(e["event"], out[0], out[1],
                                               out[2], e["accepts"])
        self._drain_active = self._drain_spec_block(
            toks, dones, emits, accs, self._drain_active)

    def _drain_spec_block(self, toks, dones, emits, accs, mask):
        """Host bookkeeping of one fetched round, shared by the synchronous
        lane and the overlap drain.  ``toks`` / ``dones`` / ``emits`` are
        ``[C, B]`` (committed token, just-retired rows, validity) and
        ``accs`` the raw accepted-draft counts; ``mask`` is the
        device-active mask at the round's dispatch; returns the mask after
        it.  A row committed ``n_emit`` tokens: the worst-case lens mirror
        (C at dispatch) is corrected to it, the draft cache's lens follows
        the target's, and ``prev`` takes the second-to-last committed token
        before ``_next_tok`` moves.  A stop sequence delivers token by token
        and retires where the plain lane would, the over-committed tail
        discarded and counted in ``horizon_trimmed_tokens``.  Drafted
        counts come from the device-chain mask, so the overlap lane's
        phantom rounds past a row's done never count."""
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        cache, dcache = self.cache, self._spec_dcache
        C = toks.shape[0]
        G = C - 1
        lookup = self._spec.source == "prompt_lookup"
        n_spec = int((mask & self._spec_on).sum())
        advanced = 0
        trimmed = 0
        acc_round = 0
        out_mask = mask.copy()
        for slot in np.nonzero(mask)[0]:
            slot = int(slot)
            n_emit = int(emits[:, slot].sum())
            device_done = bool(dones[:n_emit, slot].any())
            if device_done:
                out_mask[slot] = False     # the device chain dropped it
            req = self._active.get(slot)
            if req is not None and n_emit > 0:
                cache.lens[slot] -= C - n_emit
                if dcache is not None and self._spec_on[slot]:
                    dcache.lens[slot] = cache.lens[slot]
            if req is None or n_emit == 0:
                # retired on the host (stop sequence, cancel) before this
                # round drained: its tokens are dead
                continue
            if self._spec_on[slot]:
                k = int(accs[slot])
                acc_round += k
                self._accept_ema = 0.8 * self._accept_ema + 0.2 * k
                if self.metrics is not None:
                    self.metrics.spec_accept_len.observe(k)
            col = toks[:, slot]
            if n_emit >= 2:
                self._prev_tok[slot] = int(col[n_emit - 2])
            else:
                self._prev_tok[slot] = int(self._next_tok[slot])
            if lookup:
                self._spec_note_tokens(slot, col[:n_emit])
            if req.stop_sequences:
                for h in range(n_emit):
                    t = int(col[h])
                    self._deliver_token(slot, req, t)
                    advanced += 1
                    self._remaining[slot] -= 1
                    if h == n_emit - 1 and device_done:
                        self._retire(slot)   # eos / budget (on the device)
                    elif self._hit_stop(req, t):
                        self._retire(slot)   # stop sequence (host only)
                        if self._inflight or self._dev is not None:
                            self._needs_flush = True
                        trimmed += n_emit - 1 - h
                        break
                continue
            # no stop sequence: the column lands as one bulk extend
            got = col[:n_emit].tolist()
            req.generated.extend(got)
            self.tokens_generated += n_emit
            advanced += n_emit
            self._note_first_token(req)
            self._stream.extend((req.rid, t) for t in got)
            self._next_tok[slot] = got[-1]
            self._remaining[slot] -= n_emit
            if device_done:
                self._retire(slot)
        if n_spec:
            self.spec_rounds += 1
            self.spec_drafted += G * n_spec
            self.spec_accepted += acc_round
            if self.adaptive_gamma:
                self._spec_retune()
            if self.metrics is not None:
                m = self.metrics
                m.spec_rounds.inc()
                m.spec_drafted_tokens.inc(G * n_spec)
                m.spec_accepted_tokens.inc(acc_round)
                m.spec_gamma.set(self.gamma)     # after a retune: the next
                m.spec_acceptance.set(
                    self.spec_accepted / max(self.spec_drafted, 1))
        if trimmed:
            self.horizon_trimmed_tokens += trimmed
            if self.metrics is not None:
                self.metrics.horizon_trimmed_tokens.inc(trimmed)
        if self.metrics is not None:
            self.metrics.tokens_generated.inc(advanced)
            self.metrics.host_bookkeeping.observe(time.perf_counter() - t0)
        return out_mask

    def _spec_retune(self) -> None:
        """Adaptive gamma for the next round from the acceptance EMA: down
        when drafts keep missing, up when they keep landing (each distinct
        gamma builds one step function, and on the overlap lane captures
        one graph, once)."""
        if self._accept_ema < 0.4 * self.gamma and self.gamma > 1:
            self.gamma -= 1
        elif self._accept_ema > 0.85 * self.gamma and \
                self.gamma < self.max_gamma:
            self.gamma += 1

    def _pipeline_flush(self) -> None:
        """Drain every in-flight dispatch and drop the device-resident
        loop state.  Called at every scheduler mutation point; afterwards
        the host arrays are authoritative and the next dispatch re-seeds
        the device from them."""
        if not self._inflight and self._dev is None \
                and not self._needs_flush:
            return
        while self._inflight:
            self._drain_one()
        if self.cache.host is not None:
            # a scheduler mutation point: wait for the staged swap-out
            # copies that rode under the drained dispatches
            self.cache.host.flush()
        self._dev = None
        self._needs_flush = False
        self.pipeline_flushes += 1


class EngineSupervisor:
    """Crash recovery over :class:`ContinuousBatchingEngine`: drive it
    through :meth:`step` and, when a step exception escapes the engine's
    own quarantine (consecutive-fault escalation, a poisoned allocator, an
    out-of-memory error), rebuild the engine from ``factory`` and carry
    the live work over: queued requests move with their rids, deadlines
    and timestamps; active requests and those popped mid-admission retire
    with ``status == "error"`` (their pages died with the engine); the
    results ``finished()`` has not handed out yet, and the tracer, survive.

    Restart budget: ``max_restarts`` within a sliding ``window_s``, each
    after an exponential ``backoff_s * 2**k`` sleep (``backoff_s=0``
    sleeps never).  Past it :class:`EngineDeadError` raises and the
    serving front fails pending requests loudly.

    Lifecycle: ``state`` is ``READY``, ``DRAINING`` or ``DEAD``;
    :meth:`drain` stops admission while the work in flight finishes
    (``drained`` turns True) and :meth:`resume` opens it again.

    ``factory()`` returns a fresh engine.  Reusing the dead engine's
    params and cache is the cheap rebuild (LLaMA-7B's weights are 13.5 GB):
    the dead engine's rows are released first, so the page accounting
    starts clean, and the decode graphs keyed by those params and pools
    replay with no new capture.  A rebuild over another cache drops the
    dead engine's graphs (nothing reaches them again) with their private
    memory pools."""

    def __init__(self, factory, max_restarts: int = 3,
                 window_s: float = 60.0, backoff_s: float = 0.05):
        self._factory = factory
        self.engine: ContinuousBatchingEngine = factory()
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.backoff_s = float(backoff_s)
        self.restarts = 0
        self._restart_times: deque = deque()
        self._draining = False
        self._dead = False

    # -- lifecycle ---------------------------------------------------------
    @property
    def state(self) -> str:
        """``READY`` (serving), ``DRAINING`` (finishing the work in
        flight, refusing new submissions) or ``DEAD`` (restart budget
        exhausted)."""
        if self._dead:
            return "DEAD"
        if self._draining:
            return "DRAINING"
        return "READY"

    def drain(self) -> None:
        """Stop admitting: ``submit()`` raises while ``step()`` finishes
        the queued and active work; ``drained`` turns True when none is
        left."""
        self._draining = True

    def resume(self) -> None:
        """Open admission again after a :meth:`drain`."""
        self._draining = False

    @property
    def drained(self) -> bool:
        """True once a drain has finished its work in flight."""
        return self._draining and not self.engine.has_work()

    # -- the engine's API, passed through ------------------------------------
    def submit(self, *a, **kw) -> int:
        if self._dead:
            raise EngineDeadError("engine dead: restart budget exhausted")
        if self._draining:
            raise RuntimeError(
                "engine draining: not admitting new requests (the work in "
                "flight is finishing; restart, replace or resume() follows)")
        return self.engine.submit(*a, **kw)

    def cancel(self, rid: int) -> bool:
        return self.engine.cancel(rid)

    def finished(self) -> List[Request]:
        return self.engine.finished()

    def drain_stream(self) -> List:
        return self.engine.drain_stream()

    def has_work(self) -> bool:
        return self.engine.has_work()

    def step(self) -> int:
        try:
            return self.engine.step()
        except Exception as exc:
            self._restart(exc)
            return len(self.engine._active)

    def run_to_completion(self, max_steps: int = 10_000):
        return _drive_to_completion(self, max_steps)

    def _restart(self, exc: BaseException) -> None:
        now = time.monotonic()
        while self._restart_times and \
                now - self._restart_times[0] > self.window_s:
            self._restart_times.popleft()
        if len(self._restart_times) >= self.max_restarts:
            self._dead = True
            raise EngineDeadError(
                f"engine unrecoverable after {self.restarts} restart(s) "
                f"({len(self._restart_times)} in the last "
                f"{self.window_s:.0f}s): {type(exc).__name__}: {exc}"
            ) from exc
        if self.backoff_s > 0:
            time.sleep(self.backoff_s * (2 ** len(self._restart_times)))
        old = self.engine
        text = f"{type(exc).__name__}: {exc}"
        _release_engine_claims(old)
        new = self._factory()
        if new.tracer is None:
            # factory-built engines rarely carry a tracer: keep the
            # serving front's tracing alive across restarts
            new.tracer = old.tracer
        if new.params is not old.params or new.cache is not old.cache:
            # nothing reaches the dead engine's decode graphs again
            graphed_step.forget(old.params, old._pools())
        # results the serving front has not drained yet survive
        new._finished.extend(old._finished)
        old._finished = []

        def fail(req):
            req.done, req.status, req.error = True, "error", text
            req.t_finish = time.monotonic()
            new._count_abnormal(req, "error")
            _finalize_trace(req)
            new._finished.append(req)

        # active requests died with their pages
        for req in old._active.values():
            fail(req)
        old._active.clear()
        # requests the fatal step popped off the queue but did not commit
        # to _active (an admission-phase death) fail loudly too
        for req in old._admitting:
            if not req.done and not any(q is req for q in old._queue):
                fail(req)
        old._admitting = []
        # rows parked mid-prefill on the mixed lane died with their pages
        for ent in old._mixed_pref.values():
            if not ent["req"].done:
                fail(ent["req"])
        old._mixed_pref.clear()
        # the live queue moves over with its rids; cancelled and expired
        # requests retire on the way
        for req in old._queue:
            req.slot = None
            if req.rid in old._cancelled:
                new._finish_queued_abnormal(req, "cancelled")
            elif req.deadline and new._now() >= req.deadline:
                new._finish_queued_abnormal(req, "expired")
            else:
                new._queue.append(req)
                if req.deadline:
                    new._has_deadlines = True
                if req.priority != "normal":
                    new._has_priorities = True
        old._queue.clear()
        new._next_rid = max(new._next_rid, old._next_rid)
        # engines carrying state across engines (a DecodeEngine's adopted,
        # not yet admitted hand-offs; a PrefillEngine's untaken exports)
        # re-register or fail it here
        hook = getattr(new, "transplant_extra", None)
        if hook is not None:
            hook(old)
        new.last_fault = text
        self.engine = new
        self._restart_times.append(now)
        self.restarts += 1
        if new.metrics is not None:
            new.metrics.engine_restarts.inc()
            new.metrics.ring.emit("engine_restart", error=text,
                                  restarts=self.restarts)
