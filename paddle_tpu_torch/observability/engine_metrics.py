"""Instrument bundle for the serving hot path.

Counterpart of ``paddle_tpu/observability/engine_metrics.py`` (the port's
own copy).  One :class:`EngineMetrics` per engine: every
Counter/Gauge/Histogram the continuous-batching stack publishes, created
against one registry (the process-wide default for servers; a fresh
registry in tests that assert exact counts).  The catalogue is JAX's
whole catalogue, name for name and type for type: the instruments of
lanes the port does not have yet (TP) are registered and read 0, as they
do on a JAX engine with those lanes off.

Gauges derivable from engine/cache state use scrape-time callbacks
(``set_function``) through a weakref — the hot path pays nothing to
keep them fresh, and a registry outliving its engine reads 0 instead
of pinning the engine (and its device pools) alive.  A callback runs on
the scraping thread while the drive thread may be capturing or replaying
a CUDA graph, so it reads host state only (lengths of host containers,
the allocator's free list), never a CUDA tensor.
"""

from __future__ import annotations

import weakref

from .events import EventRing
from .metrics import MetricsRegistry, default_registry

__all__ = ["EngineMetrics", "bind_engine_gauges"]

# step/decode latencies: 100us .. 10s
_STEP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# per-token cadence (TPOT): 100us .. 2.5s
_TPOT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# packed-prefill stream sizes: one prefill bucket .. long-context
# admission waves (token counts, powers of two like the bucketing)
_PACKED_BUCKETS = (64.0, 128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0,
                   8192.0, 16384.0, 32768.0, 65536.0, 131072.0)
# mixed-tick piggybacked prefill tokens: a page .. large budgets
# (token counts; utilization = sum/count over the configured budget)
_BUDGET_BUCKETS = (8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
                   1024.0, 2048.0, 4096.0)
# tokens delivered per multi-token horizon block: one row's single
# token .. a full H=32 block over a wide batch
_HORIZON_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                    256.0, 512.0)
# accepted-draft run length per row per speculative round: 0 (all
# rejected) .. a large adaptive gamma landing in full
_SPEC_ACCEPT_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0,
                        16.0)
# host bookkeeping per decode step: 10us .. 1s (pure Python work —
# far below the dispatch buckets; the overlap ratio
# host_bookkeeping.sum / decode_step.sum needs resolution down here)
_HOST_BUCKETS = (0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
                 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 1.0)
# KV page swap / preempt-resume latencies: 10us (a few staged pages on
# CPU) .. 10s (a long context restored over a slow link)
_SWAP_BUCKETS = (0.00001, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 10.0)


class EngineMetrics:
    """All instruments the serving stack records into.

    ``registry=None`` uses the process-wide default registry (several
    engines then share instruments — counters aggregate, callback
    gauges track the most recently constructed engine, which is the
    Prometheus process-wide reading).  Pass a fresh
    :class:`MetricsRegistry` for per-engine isolation.
    """

    def __init__(self, registry: MetricsRegistry = None, ring=None):
        r = registry if registry is not None else default_registry()
        self.registry = r
        # the engine's lifecycle events get their own ring by default
        # (per-engine /events isolation); pass
        # observability.default_ring() to aggregate process-wide
        self.ring = ring if ring is not None else EventRing()

        # -- request lifecycle ------------------------------------------
        self.requests_submitted = r.counter(
            "paddle_tpu_engine_requests_submitted_total",
            "Requests accepted by submit()")
        self.requests_finished = r.counter(
            "paddle_tpu_engine_requests_finished_total",
            "Requests retired (eos/stop/max_new_tokens)")
        self.preemptions = r.counter(
            "paddle_tpu_engine_preemptions_total",
            "Active requests evicted + requeued on pool exhaustion")
        # -- fault tolerance (docs/FAULT_TOLERANCE.md) ------------------
        self.requests_cancelled = r.counter(
            "paddle_tpu_engine_requests_cancelled_total",
            "Requests retired by cancel() — client cancellation or a "
            "mid-stream HTTP disconnect")
        self.requests_expired = r.counter(
            "paddle_tpu_engine_requests_expired_total",
            "Requests retired at their deadline_s before completing")
        self.requests_rejected = r.counter(
            "paddle_tpu_engine_requests_rejected_total",
            "submit() calls refused by the bounded admission queue "
            "(max_queue_len / max_queued_tokens backpressure; HTTP "
            "maps these to 429)")
        # -- QoS / SLO guardrails (class-aware shedding + quotas) -------
        self.requests_degraded = r.counter(
            "paddle_tpu_engine_requests_degraded_total",
            "Requests admitted DEGRADED under overload (normal class "
            "past the soft queue bound: halved max_new_tokens, spec "
            "off; the done message carries the flag)")
        self.quota_rejected = r.counter(
            "paddle_tpu_engine_quota_rejected_total",
            "submit() calls refused because the request's tenant was "
            "over its token-rate quota (QuotaExceededError; HTTP 429 "
            "with a refill-derived Retry-After)")
        self.queued_high = r.gauge(
            "paddle_tpu_engine_queued_high_count",
            "Waiting requests of priority class 'high'")
        self.queued_normal = r.gauge(
            "paddle_tpu_engine_queued_normal_count",
            "Waiting requests of priority class 'normal'")
        self.queued_low = r.gauge(
            "paddle_tpu_engine_queued_low_count",
            "Waiting requests of priority class 'low'")
        self.requests_faulted = r.counter(
            "paddle_tpu_engine_requests_faulted_total",
            "Requests retired with an error done-message because the "
            "decode wave they rode faulted (step-exception "
            "quarantine or an engine restart)")
        self.engine_restarts = r.counter(
            "paddle_tpu_engine_restarts_total",
            "Dead-engine rebuilds by EngineSupervisor (queued "
            "requests re-queued, active ones faulted)")
        self.queued_tokens = r.gauge(
            "paddle_tpu_engine_queued_tokens_count",
            "Context tokens waiting in the admission queue (the "
            "max_queued_tokens backpressure bound reads this)")
        self.queue_wait = r.histogram(
            "paddle_tpu_request_queue_wait_seconds",
            "submit() -> first admission")
        self.ttft = r.histogram(
            "paddle_tpu_request_ttft_seconds",
            "submit() -> first generated token")
        self.tpot = r.histogram(
            "paddle_tpu_request_tpot_seconds",
            "Mean inter-token time per finished unpreempted request "
            "(excludes TTFT and requeue waits)",
            buckets=_TPOT_BUCKETS)

        # -- decode / prefill dispatches --------------------------------
        self.decode_steps = r.counter(
            "paddle_tpu_engine_decode_steps_total",
            "Decode dispatches (speculative: draft+verify rounds)")
        self.decode_seconds = r.histogram(
            "paddle_tpu_engine_decode_step_seconds",
            "Wall time of one decode dispatch (host-observed)",
            buckets=_STEP_BUCKETS)
        self.tokens_generated = r.counter(
            "paddle_tpu_engine_tokens_generated_total",
            "Tokens emitted across all requests")
        self.prefill_dispatches = r.counter(
            "paddle_tpu_engine_prefill_dispatches_total",
            "Jitted prefill program dispatches (batched admits "
            "count once)")
        self.prefill_chunks = r.counter(
            "paddle_tpu_engine_prefill_chunks_total",
            "Chunks processed by chunked-prefill admissions")
        self.prefill_padded_tokens = r.counter(
            "paddle_tpu_engine_prefill_padded_tokens_total",
            "Dispatched prefill token slots that carried no real "
            "context token (bucket/page padding waste, all lanes)")
        self.prefill_packed_tokens = r.histogram(
            "paddle_tpu_engine_prefill_packed_tokens",
            "Packed-stream token slots per packed admission wave "
            "(one sample per packed prefill dispatch)",
            buckets=_PACKED_BUCKETS)
        # -- mixed prefill+decode lane (token-budget piggybacking) ------
        self.mixed_ticks = r.counter(
            "paddle_tpu_engine_mixed_ticks_total",
            "Decode dispatches that piggybacked prefill-stream "
            "tokens (mixed=True: the engine admits without stalling "
            "decode)")
        self.mixed_prefill_tokens = r.counter(
            "paddle_tpu_engine_mixed_piggybacked_prefill_tokens_total",
            "Fresh context tokens prefilled INSIDE mixed decode "
            "dispatches instead of dedicated admission waves")
        self.mixed_budget_tokens = r.histogram(
            "paddle_tpu_engine_mixed_budget_tokens",
            "Fresh prefill tokens one mixed tick consumed (bounded "
            "by mixed_token_budget; sum/count against the configured "
            "budget is the budget utilization)",
            buckets=_BUDGET_BUCKETS)
        # -- multi-token decode horizon (decode_horizon=H) ---------------
        self.decode_horizon_tokens = r.histogram(
            "paddle_tpu_engine_decode_horizon_tokens",
            "Tokens delivered per multi-token horizon block (one "
            "sample per drained H-micro-step dispatch; sum/count "
            "against H x active slots is the horizon utilization — "
            "rows retiring mid-block deliver less)",
            buckets=_HORIZON_BUCKETS)
        self.horizon_trimmed_tokens = r.counter(
            "paddle_tpu_engine_horizon_trimmed_tokens_total",
            "Tokens the device over-generated past a host-detected "
            "stop sequence inside a horizon block and the drain "
            "discarded before emission (at most H-1 per stop; the "
            "token cost of fusing H micro-steps into one dispatch "
            "under aggressive stop-sequence traffic)")
        self.host_bookkeeping = r.histogram(
            "paddle_tpu_engine_host_bookkeeping_seconds",
            "Host-side scheduling/streaming bookkeeping per decode "
            "step (overlap mode hides this behind the in-flight "
            "dispatch; sum/decode_step_seconds.sum is the host "
            "overhead fraction)",
            buckets=_HOST_BUCKETS)
        self.tp_allreduce_bytes = r.counter(
            "paddle_tpu_engine_tp_allreduce_bytes_total",
            "Analytic bytes one device sends in the per-layer output "
            "collectives (attention wo + FFN w_down) of TP decode "
            "dispatches — tp_allreduce='int8' moves ~25-31% of a "
            "4-byte fp32 wire (~53-56% of a bf16 wire); embed psum "
            "and the logits all-gather are mode-independent and "
            "excluded")
        self.tp_collective_seconds = r.histogram(
            "paddle_tpu_engine_tp_collective_seconds",
            "Host-observed wall time of one collective-bearing TP "
            "decode round (recorded only by mp>1 engines; the "
            "collectives themselves are fused into the dispatch, so "
            "this is the round wall, comparable across "
            "tp_allreduce modes)",
            buckets=_STEP_BUCKETS)
        self.inflight_dispatches = r.gauge(
            "paddle_tpu_engine_inflight_dispatches_count",
            "Decode dispatches issued but not yet drained by the "
            "host (dispatch-ahead serving pipeline depth)")
        self.batch_occupancy = r.gauge(
            "paddle_tpu_engine_batch_occupancy_ratio",
            "Active slots / decode batch size")
        self.active_requests = r.gauge(
            "paddle_tpu_engine_active_requests_count",
            "Requests holding a decode slot")
        self.queued_requests = r.gauge(
            "paddle_tpu_engine_queued_requests_count",
            "Requests waiting for admission")

        # -- paged KV cache ---------------------------------------------
        self.prefix_hit_pages = r.counter(
            "paddle_tpu_kvcache_prefix_hit_pages_total",
            "Prompt pages reused from the prefix index")
        self.prefix_miss_pages = r.counter(
            "paddle_tpu_kvcache_prefix_miss_pages_total",
            "Prompt pages freshly prefilled on prefix-cached admits")
        self.kv_free_pages = r.gauge(
            "paddle_tpu_kvcache_free_pages_count",
            "Pages on the free list")
        self.kv_utilization = r.gauge(
            "paddle_tpu_kvcache_page_utilization_ratio",
            "Allocated usable pages / usable pool (page 0 reserved)")

        # -- two-tier KV cache (host-RAM page offload) ------------------
        self.swap_out_pages = r.counter(
            "paddle_tpu_kvcache_swap_out_pages_total",
            "KV pages moved device -> host tier (preemption swap-outs "
            "+ prefix-cache demotions)")
        self.swap_in_pages = r.counter(
            "paddle_tpu_kvcache_swap_in_pages_total",
            "KV pages restored host -> device (swap-in resumes + "
            "prefix promotions)")
        self.swap_bytes = r.counter(
            "paddle_tpu_kvcache_swap_bytes_total",
            "Bytes moved between the device pool and the host tier, "
            "both directions")
        self.swap_seconds = r.histogram(
            "paddle_tpu_kvcache_swap_seconds",
            "Host-observed wall time of one swap-out staging (gather "
            "dispatch + async-copy setup; the copy itself overlaps "
            "decode)",
            buckets=_SWAP_BUCKETS)
        self.host_pool_pages = r.gauge(
            "paddle_tpu_kvcache_host_pool_pages",
            "Host-tier pages in use (swapped rows + demoted prefixes)")
        self.host_pool_free_pages = r.gauge(
            "paddle_tpu_kvcache_host_pool_free_pages",
            "Host-tier pages on the free list (0 when no host tier "
            "is attached)")
        self.preempt_resume_swapped = r.counter(
            "paddle_tpu_engine_preempt_resume_swapped_total",
            "Preempted requests re-admitted via host-tier page "
            "restore (zero prefill tokens)")
        self.preempt_resume_recompute = r.counter(
            "paddle_tpu_engine_preempt_resume_recompute_total",
            "Preempted requests re-admitted via context re-prefill "
            "(no host tier, host tier full, or cost model chose "
            "recompute)")
        self.preempt_resume_seconds = r.histogram(
            "paddle_tpu_engine_preempt_resume_seconds",
            "Re-admission wall per preempted request (swap-in "
            "restore, or the admission wall of an all-resume "
            "recompute wave)",
            buckets=_SWAP_BUCKETS)
        self.prefill_tokens_avoided = r.counter(
            "paddle_tpu_engine_prefill_tokens_avoided_total",
            "Context tokens restored from the host tier instead of "
            "being re-prefilled")

        # -- speculative decoding (fused draft+verify lane) -------------
        self.spec_rounds = r.counter(
            "paddle_tpu_engine_spec_rounds_total",
            "Fused speculative draft+verify rounds (one dispatch "
            "each)")
        self.spec_drafted_tokens = r.counter(
            "paddle_tpu_engine_spec_drafted_tokens_total",
            "Draft tokens proposed (gamma per spec-on row per round)")
        self.spec_accepted_tokens = r.counter(
            "paddle_tpu_engine_spec_accepted_tokens_total",
            "Draft tokens accepted by exact greedy verification")
        self.spec_accept_len = r.histogram(
            "paddle_tpu_engine_spec_accept_len_tokens",
            "Accepted-draft run length per row per round (0..gamma; "
            "the row always commits one extra exact token on top)",
            buckets=_SPEC_ACCEPT_BUCKETS)
        self.spec_gamma = r.gauge(
            "paddle_tpu_engine_spec_gamma_tokens",
            "Current draft length (adaptive gamma retunes it)")
        self.spec_acceptance = r.gauge(
            "paddle_tpu_engine_spec_acceptance_ratio",
            "Accepted draft tokens / drafted tokens, lifetime")


def _weak_fn(obj, fn, default: float = 0.0):
    """Scrape callback holding only a weakref to its owner: a dead
    engine reads ``default`` instead of being pinned alive by the
    process-wide registry."""
    ref = weakref.ref(obj)

    def call():
        o = ref()
        return default if o is None else fn(o)

    return call


def bind_engine_gauges(m: EngineMetrics, engine) -> None:
    """Point the callback gauges at one engine (+ its cache).  Called
    from the engine constructor; re-binding (a newer engine on the
    shared default registry) is last-writer-wins by design.  The host
    tier's page gauges read 0 on a cache without one."""
    cache = engine.cache
    # rows parked mid-prefill on the mixed lane hold a slot: they count as
    # active and occupying, as in JAX
    m.active_requests.set_function(
        _weak_fn(engine,
                 lambda e: float(len(e._active) + len(e._mixed_pref))))
    m.queued_requests.set_function(
        _weak_fn(engine, lambda e: float(len(e._queue))))
    m.queued_tokens.set_function(
        _weak_fn(engine, lambda e: float(e.queued_tokens())))
    m.queued_high.set_function(
        _weak_fn(engine,
                 lambda e: float(e.queued_by_class()["high"])))
    m.queued_normal.set_function(
        _weak_fn(engine,
                 lambda e: float(e.queued_by_class()["normal"])))
    m.queued_low.set_function(
        _weak_fn(engine,
                 lambda e: float(e.queued_by_class()["low"])))
    m.batch_occupancy.set_function(
        _weak_fn(engine,
                 lambda e: (len(e._active) + len(e._mixed_pref)) / e.B))
    m.inflight_dispatches.set_function(
        _weak_fn(engine, lambda e: float(len(e._inflight))))
    m.kv_free_pages.set_function(
        _weak_fn(cache, lambda c: float(c.free_pages())))
    usable = max(cache.num_pages - 1, 1)       # page 0 reserved
    m.kv_utilization.set_function(
        _weak_fn(cache,
                 lambda c: 1.0 - c.free_pages() / usable))
    m.host_pool_pages.set_function(
        _weak_fn(cache,
                 lambda c: float(c.host.used_pages())
                 if c.host is not None else 0.0))
    m.host_pool_free_pages.set_function(
        _weak_fn(cache,
                 lambda c: float(c.host.free_pages())
                 if c.host is not None else 0.0))
