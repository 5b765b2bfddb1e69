"""The port's observability package (``paddle_tpu_torch.observability``) and
its wiring through the port's engine, held against paddle_tpu's.

* The registry: the same operations on both packages' registries give a
  byte-identical ``render_prometheus()`` text and an equal ``snapshot()``.
* The unit invariants of ``tests/test_observability.py`` in the port:
  counters are monotonic, a type mismatch raises, a failing gauge callback
  reads NaN, histogram buckets are cumulative, the instruments are thread
  safe, the ring is bounded and seq-tagged, a follower sees the gap of a
  wrap, and a ring span imports nothing on its hot path.
* ``EngineMetrics``: the same names, types and help texts as JAX's.
* The same prompts through the JAX engine and the port's engine, on the
  2-layer fp32 config of ``tests/test_observability.py`` with the same
  weights (``params_from_jax``): equal counter values, equal gauges after
  the drain, equal histogram counts (and equal sums where the unit is not
  seconds), the same ring events (names and every field but the clocks),
  on the packed, batched, chunked and prefix lanes, overlap, horizon 4,
  overlap + horizon 4, recompute preemption (sync and overlap) and
  cancel / deadline endings.  ``eos_id`` is None throughout, so every
  count is fixed by the schedule alone, not by near-tie tokens.
* Scrape threads: the callback gauges call no torch function, and
  instrumentation on or off gives the same tokens and the same
  ``host_syncs`` and ``pipeline_flushes`` on every lane.
* ``tools/metrics_dump.py`` reads a port server's ``/metrics``,
  ``/stats``, ``/events``, ``/traces`` and ``/trace/<rid>`` unchanged.

* The mixed lane (``mixed=True``, sync and overlap): its instruments
  (``mixed_ticks``, piggybacked prefill tokens, the budget histogram)
  equal JAX's, and ``/health``'s ``mixed_budget_utilization`` follows
  JAX's formula.

The swap instruments are held in ``tests/test_torch_kv_offload.py`` and
``tests/test_torch_serving_swap.py``.  JAX's speculative, TP, quota,
restart, fleet, disaggregation and comm-watchdog cases wait for their
lanes (ROADMAP.md).
"""

import importlib
import json
import math
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http, generate_http_stream)
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine, QueueFullError)
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
CACHE = dict(num_pages=64, pages_max=8, batch=2, page=16)
# the fields of a ring event that are clocks or thread ids
CLOCK_FIELDS = ("ts", "wall", "tid", "dur_s")


@pytest.fixture(scope="module")
def models():
    jcfg = jlp.LlamaPretrainConfig(**KW, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**KW, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(0), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _port_engine(models, registry=None, cache_kw=None, **kw):
    _, tcfg, _, tparams = models
    ck = dict(CACHE, **(cache_kw or {}))
    cache = tpd.PagedKVCache(tcfg, device="cpu", **ck)
    return ContinuousBatchingEngine(tcfg, tparams, cache,
                                    metrics_registry=registry, **kw)


def _jax_engine(models, registry, cache_kw=None, **kw):
    jcfg, _, jparams, _ = models
    ck = dict(CACHE, **(cache_kw or {}))
    cache = jpd.PagedKVCache(jcfg, **ck)
    return jse.ContinuousBatchingEngine(jcfg, jparams, cache,
                                        metrics_registry=registry, **kw)


def _md():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return importlib.import_module("metrics_dump")
    finally:
        sys.path.pop(0)


# ---------------------------------------------------------------------------
# the registry against JAX's
# ---------------------------------------------------------------------------
def _exercise(obs):
    """One sequence of registry operations: every instrument kind, help
    texts present and absent, integral, fractional, huge and NaN values,
    default and custom buckets, exemplars."""
    r = obs.MetricsRegistry()
    c = r.counter("paddle_tpu_test_things_total", "things done")
    for a in (1, 2.5, 0.1, 0.2):
        c.inc(a)
    r.counter("paddle_tpu_test_idle_total")
    g = r.gauge("paddle_tpu_test_depth_count", "queue depth")
    g.set(4)
    g.inc()
    g.dec(0.25)
    r.gauge("paddle_tpu_test_share_ratio", "a callback").set_function(
        lambda: 2 / 3)
    r.gauge("paddle_tpu_test_broken_count").set_function(lambda: 1 / 0)
    r.gauge("paddle_tpu_test_huge_bytes").set(1e16)
    h = r.histogram("paddle_tpu_test_latency_seconds", "latency")
    for i, v in enumerate((0.0005, 0.003, 0.003, 0.7, 100.0, 0.025)):
        h.observe(v, exemplar=f"rid{i}")
    s = r.histogram("paddle_tpu_test_sizes_tokens", "sizes",
                    buckets=(1, 2.5, 64))
    for v in (0, 1, 2, 3, 64, 65):
        s.observe(v)
    r.histogram("paddle_tpu_test_empty_seconds", buckets=(0.5,))
    # get-or-create hands the same instrument back
    r.counter("paddle_tpu_test_things_total").inc(3)
    return r


def test_registry_renders_jax_bytes_and_snapshot():
    jr, tr = _exercise(jobs), _exercise(tobs)
    assert tr.render_prometheus() == jr.render_prometheus()
    assert tr.snapshot() == jr.snapshot()
    assert tr.names() == jr.names()
    assert tobs.MetricsRegistry().render_prometheus() == ""
    assert tobs.metrics.DEFAULT_BUCKETS == jobs.metrics.DEFAULT_BUCKETS


def test_engine_metrics_catalogue_equals_jax():
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jobs.EngineMetrics(jr)
    tobs.EngineMetrics(tr)
    kinds = {n: tr.get(n).kind for n in tr.names()}
    assert kinds == {n: jr.get(n).kind for n in jr.names()}
    assert len(kinds) >= 50
    for n in tr.names():
        assert tr.get(n).help == jr.get(n).help, n
        if kinds[n] == "histogram":
            assert tr.get(n).buckets == jr.get(n).buckets, n
    # the untouched catalogue renders the same bytes
    assert tr.render_prometheus() == jr.render_prometheus()
    # the trace store's and the HTTP front's names as well
    jr2, tr2 = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jobs.TraceStore(metrics_registry=jr2)
    tobs.TraceStore(metrics_registry=tr2)
    from paddle_tpu.inference import serving as jserving
    from paddle_tpu_torch.inference import serving as tserving
    jserving._http_metrics(jr2)
    tserving._http_metrics(tr2)
    assert tr2.render_prometheus() == jr2.render_prometheus()


# ---------------------------------------------------------------------------
# unit invariants (tests/test_observability.py, in the port)
# ---------------------------------------------------------------------------
def test_counter_monotonic_and_negative_rejected():
    c = tobs.MetricsRegistry().counter("paddle_tpu_test_things_total", "h")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 3.5


def test_registration_idempotent_type_mismatch_raises():
    r = tobs.MetricsRegistry()
    assert r.counter("paddle_tpu_test_things_total") is \
        r.counter("paddle_tpu_test_things_total")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("paddle_tpu_test_things_total")
    with pytest.raises(ValueError, match="invalid metric name"):
        r.counter("bad name!")
    r.unregister("paddle_tpu_test_things_total")
    assert r.get("paddle_tpu_test_things_total") is None


def test_gauge_set_function_and_error_isolation():
    r = tobs.MetricsRegistry()
    g = r.gauge("paddle_tpu_test_depth_count")
    g.set(4)
    g.inc()
    assert g.value == 5.0
    g.set_function(lambda: 7.25)
    assert g.value == 7.25
    g.set(1.0)                            # set clears the callback
    assert g.value == 1.0

    def boom():
        raise RuntimeError("scrape must survive")

    g.set_function(boom)
    assert math.isnan(g.value)
    assert r.snapshot()["paddle_tpu_test_depth_count"]["value"] is None
    assert "paddle_tpu_test_depth_count NaN" in r.render_prometheus()


def test_histogram_buckets_cumulative_and_validation():
    h = tobs.MetricsRegistry().histogram(
        "paddle_tpu_test_latency_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0, 0.01):
        h.observe(v)
    assert h.count == 6
    assert h.sum == pytest.approx(5.615)
    assert h.cumulative() == [2, 4, 5, 6]     # le is inclusive
    assert h.snapshot()["buckets"]["+Inf"] == 6
    with pytest.raises(ValueError, match="strictly increase"):
        tobs.Histogram("paddle_tpu_test_bad_seconds", buckets=(1.0, 1.0))
    with pytest.raises(ValueError):
        tobs.Histogram("paddle_tpu_test_bad_seconds", buckets=())
    h.observe(0.02, exemplar=7)
    h.observe(0.001, exemplar="8")
    ex = h.snapshot()["exemplars"]
    assert ex["max"] == {"value": 0.02, "trace_id": "7"}
    assert ex["last"] == {"value": 0.001, "trace_id": "8"}


def test_thread_safety_smoke():
    r = tobs.MetricsRegistry()
    c = r.counter("paddle_tpu_test_hammer_total")
    h = r.histogram("paddle_tpu_test_hammer_seconds", buckets=(0.5,))
    ring = tobs.EventRing(capacity=100)

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(0.25)
            ring.emit("hammer")

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == 8000 and h.count == 8000
    assert h.cumulative() == [8000, 8000]
    assert len(ring) == 100 and ring.dropped == 7900
    seqs = [e["seq"] for e in ring.recent()]
    assert seqs == list(range(7901, 8001))


def test_event_ring_bounded_seq_and_follower_gap():
    ring = tobs.EventRing(capacity=4)
    for i in range(6):
        ring.emit("tick", i=i)
    assert len(ring) == 4 and ring.dropped == 2
    evs = ring.recent()
    assert [e["i"] for e in evs] == [2, 3, 4, 5]
    assert [e["seq"] for e in evs] == [3, 4, 5, 6]
    assert [e["i"] for e in ring.recent(since=4)] == [4, 5]
    assert len(ring.recent(n=2)) == 2 and ring.recent(n=0) == []
    lines = ring.to_jsonl().splitlines()
    assert len(lines) == 4 and json.loads(lines[0])["name"] == "tick"
    # a follower whose cursor fell behind a wrap is told how many it lost
    for i in range(6, 12):
        ring.emit("tick", i=i)
    evs, gap = ring.recent_with_gap(since=5)
    assert gap == 3 and [e["seq"] for e in evs] == [9, 10, 11, 12]
    assert ring.recent_with_gap(since=10) == (ring.recent()[-2:], 0)
    ring2 = tobs.EventRing(capacity=2)
    for _ in range(10):
        ring2.emit("t")
    evs, gap = ring2.recent_with_gap(since=2)
    assert gap == 6 and [e["seq"] for e in evs] == [9, 10]
    assert len(ring2.drain()) == 2 and len(ring2) == 0
    with pytest.raises(ValueError):
        tobs.EventRing(capacity=0)


def test_ring_span_no_import_in_hot_path(monkeypatch):
    """``EventRing.span()`` resolves ``torch.profiler.record_function``
    once; a span's ``__enter__`` imports nothing."""
    import builtins
    ring = tobs.EventRing()
    with ring.span("warm"):                   # resolves it
        pass
    real_import = builtins.__import__
    hits = []

    def counting(name, *a, **kw):
        if "profiler" in name:
            hits.append(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", counting)
    for _ in range(3):
        with ring.span("hot", stage="x"):
            pass
    assert hits == [], f"span __enter__ imported on the hot path: {hits}"
    evs = ring.recent()
    assert [e["name"] for e in evs] == ["warm", "hot", "hot", "hot"]
    assert evs[-1]["stage"] == "x" and evs[-1]["dur_s"] >= 0.0


def test_ring_span_lands_in_a_torch_profiler_capture():
    ring = tobs.EventRing()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ring.span("ring_span_under_profiler"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "ring_span_under_profiler" in names


def test_event_ring_chrome_export(tmp_path):
    ring = tobs.EventRing()
    ring.emit("instant_event", detail="x", blob={"not": "scalar"})
    with ring.span("spanned_work", stage="test"):
        pass
    path = ring.export_chrome_trace(str(tmp_path / "sub" / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    evs = {e["name"]: e for e in trace["traceEvents"]}
    assert set(evs) == {"instant_event", "spanned_work"}
    assert evs["spanned_work"]["ph"] == "X"
    assert evs["spanned_work"]["args"] == {"stage": "test"}
    assert evs["instant_event"]["ph"] == "i"
    assert evs["instant_event"]["args"] == {"detail": "x"}


# ---------------------------------------------------------------------------
# the port's engine against JAX's
# ---------------------------------------------------------------------------
def _plan_e2e():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(4):
        p = [int(t) for t in rng.randint(1, 128, (int(rng.randint(4, 14)),))]
        out.append((p, int(rng.randint(3, 7))))
    return [out]


def _plan_long():
    rng = np.random.RandomState(3)
    return [[([int(t) for t in rng.randint(1, 128, (L,))], 5)
             for L in (40, 10, 33, 70)]]


def _plan_prefix():
    rng = np.random.RandomState(9)
    prefix = [int(t) for t in rng.randint(1, 128, (32,))]
    tail = [int(t) for t in rng.randint(1, 128, (5,))]
    return [[(prefix, 3)], [(prefix + tail, 3), (prefix + tail[:2], 4)]]


def _plan_mixed():
    """Four requests at batch 2: the second ends early, so the third parks
    while the first still decodes, and the fourth after it."""
    rng = np.random.RandomState(3)
    return [[([int(t) for t in rng.randint(1, 128, (L,))], n)
             for L, n in ((40, 14), (10, 3), (33, 5), (70, 5))]]


def _plan_preempt():
    rng = np.random.RandomState(7)
    return [[([int(t) for t in rng.randint(1, 128, (16,))], 20)
             for _ in range(2)]]


# lane -> (engine kwargs, cache kwargs, plan): a plan is a list of rounds,
# each round's requests submitted, then run to completion
LANES = {
    "packed": ({}, {}, _plan_e2e),
    "batched": ({"packed": False}, {}, _plan_e2e),
    "chunked": ({"packed": False, "prefill_chunk": 16}, {}, _plan_long),
    "prefix_packed": ({"enable_prefix_caching": True}, {}, _plan_prefix),
    "prefix_chunked": ({"enable_prefix_caching": True, "packed": False},
                       {}, _plan_prefix),
    "overlap": ({"overlap": True}, {"batch": 4}, _plan_e2e),
    "horizon4": ({"decode_horizon": 4}, {"batch": 4}, _plan_e2e),
    "overlap_horizon4": ({"overlap": True, "decode_horizon": 4},
                         {"batch": 4}, _plan_long),
    "preemption": ({}, {"num_pages": 5, "pages_max": 4}, _plan_preempt),
    "preemption_overlap": ({"overlap": True},
                           {"num_pages": 5, "pages_max": 4}, _plan_preempt),
    # two requests admit in the cold wave; the others park and ride the
    # mixed ticks, 16 tokens a tick
    "mixed": ({"mixed": True, "mixed_token_budget": 16}, {}, _plan_mixed),
    "mixed_overlap": ({"mixed": True, "mixed_token_budget": 16,
                       "overlap": True}, {}, _plan_mixed),
}


def _serve(eng, plan, cancel_expire=False):
    """Run ``plan`` on ``eng`` -> {rid: tokens}."""
    out = {}
    for rnd in plan:
        rids = [eng.submit(p, max_new_tokens=n) for p, n in rnd]
        if cancel_expire:
            eng.submit(rnd[0][0], max_new_tokens=4, deadline_s=0.0)
            eng.cancel(rids[-1])
        for r in eng.run_to_completion():
            out[r.rid] = list(r.generated)
    return out


def _events(ring):
    return [{k: v for k, v in e.items() if k not in CLOCK_FIELDS}
            for e in ring.recent()]


def _assert_registries_agree(jreg, treg):
    assert treg.names() == jreg.names()
    js, ts = jreg.snapshot(), treg.snapshot()
    for name in jreg.names():
        j, t = js[name], ts[name]
        assert t["type"] == j["type"], name
        if j["type"] == "histogram":
            assert t["count"] == j["count"], name
            if not name.endswith("_seconds"):
                assert t["sum"] == j["sum"], name
                assert t["buckets"] == j["buckets"], name
        else:
            assert t["value"] == j["value"], (name, t["value"], j["value"])


@pytest.mark.parametrize("lane", list(LANES))
def test_engine_instruments_equal_jax(models, lane):
    kw, ck, plan_fn = LANES[lane]
    plan = plan_fn()
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jeng = _jax_engine(models, jreg, ck, **kw)
    teng = _port_engine(models, treg, ck, **kw)
    jout, tout = _serve(jeng, plan), _serve(teng, plan)
    assert {r: len(t) for r, t in tout.items()} == \
        {r: len(t) for r, t in jout.items()}
    _assert_registries_agree(jreg, treg)
    assert _events(teng.metrics.ring) == _events(jeng.metrics.ring)
    # the counters mirror the engine's own bookkeeping
    v = treg.snapshot()
    assert v["paddle_tpu_engine_decode_steps_total"]["value"] == \
        teng.decode_steps
    assert v["paddle_tpu_engine_tokens_generated_total"]["value"] == \
        teng.tokens_generated
    assert v["paddle_tpu_engine_prefill_dispatches_total"]["value"] == \
        teng.prefill_calls
    assert v["paddle_tpu_engine_preemptions_total"]["value"] == \
        teng.preemptions
    assert v["paddle_tpu_kvcache_prefix_hit_pages_total"]["value"] == \
        teng.cache.prefix_hits
    assert v["paddle_tpu_engine_decode_step_seconds"]["count"] == \
        teng.decode_steps
    n = sum(len(r) for r in plan)
    assert v["paddle_tpu_request_ttft_seconds"]["count"] == n
    assert v["paddle_tpu_request_queue_wait_seconds"]["count"] == n
    if lane.startswith("preemption"):
        assert teng.preemptions >= 1
        assert "preemption" in [e["name"] for e in _events(
            teng.metrics.ring)]
    if lane.startswith("prefix"):
        assert teng.cache.prefix_hits >= 2
    if lane.startswith("mixed"):
        assert v["paddle_tpu_engine_mixed_ticks_total"]["value"] == \
            teng.mixed_ticks > 0
        assert v["paddle_tpu_engine_mixed_piggybacked_prefill_tokens_total"][
            "value"] == teng.mixed_prefill_tokens > 0
        h = v["paddle_tpu_engine_mixed_budget_tokens"]
        assert h["count"] == teng.mixed_ticks
        assert h["sum"] == teng.mixed_prefill_tokens
    assert v["paddle_tpu_engine_inflight_dispatches_count"]["value"] == 0
    teng.cache.audit()


def test_cancel_and_deadline_endings_equal_jax(models):
    plan = _plan_e2e()
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jeng = _jax_engine(models, jreg, {"batch": 4})
    teng = _port_engine(models, treg, {"batch": 4})
    _serve(jeng, plan, cancel_expire=True)
    _serve(teng, plan, cancel_expire=True)
    _assert_registries_agree(jreg, treg)
    evs = _events(teng.metrics.ring)
    assert evs == _events(jeng.metrics.ring)
    aborted = sorted(e["status"] for e in evs
                     if e["name"] == "request_aborted")
    assert aborted == ["cancelled", "expired"]


def test_queue_full_rejection_equals_jax(models):
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jeng = _jax_engine(models, jreg, max_queue_len=1)
    teng = _port_engine(models, treg, max_queue_len=1)
    for eng, err in ((jeng, jse.QueueFullError), (teng, QueueFullError)):
        eng.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(err):
            eng.submit([4, 5], max_new_tokens=2)
        eng.run_to_completion()
    _assert_registries_agree(jreg, treg)
    assert _events(teng.metrics.ring) == _events(jeng.metrics.ring)
    assert treg.get("paddle_tpu_engine_requests_rejected_total").value == 1


def test_metrics_off_registers_nothing_and_shared_registry_aggregates(
        models):
    eng = _port_engine(models, False)
    assert eng.metrics is None and eng.cache.metrics is None
    _serve(eng, _plan_e2e())
    reg, ring = tobs.MetricsRegistry(), tobs.EventRing()
    a = _port_engine(models, reg, metrics_ring=ring)
    b = _port_engine(models, reg, metrics_ring=ring)
    _serve(a, _plan_e2e())
    _serve(b, _plan_e2e())
    assert reg.get("paddle_tpu_engine_requests_submitted_total").value == 8
    assert [e["name"] for e in ring.recent()].count("request_finished") == 8


class _TorchCalls(TorchFunctionMode):
    """Records every torch function called inside the mode."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lane", ["overlap", "horizon4", "mixed_overlap"])
def test_callback_gauges_call_no_torch_function(models, lane):
    """A scrape runs every callback gauge on the scraping thread; none may
    touch a tensor (mid-step, with dispatches in flight)."""
    kw, ck, _ = LANES[lane]
    reg = tobs.MetricsRegistry()
    eng = _port_engine(models, reg, ck, **kw)
    for p, _ in _plan_long()[0]:
        eng.submit(p, max_new_tokens=20)
    scraped = 0
    while eng.has_work():
        eng.step()
        with _TorchCalls() as mode:
            snap = reg.snapshot()
            text = reg.render_prometheus()
        assert mode.calls == [], mode.calls
        scraped += 1
        # rows parked mid-prefill on the mixed lane hold a slot: active
        assert snap["paddle_tpu_engine_active_requests_count"]["value"] == \
            len(eng._active) + len(eng._mixed_pref)
        assert "paddle_tpu_engine_inflight_dispatches_count" in text
    assert scraped > 2


@pytest.mark.parametrize("lane", ["packed", "overlap", "horizon4",
                                  "overlap_horizon4", "preemption_overlap",
                                  "mixed_overlap"])
def test_instrumentation_changes_no_token_nor_sync(models, lane):
    kw, ck, plan_fn = LANES[lane]
    plan = plan_fn()
    off = _port_engine(models, False, ck, **kw)
    on = _port_engine(models, None, ck, tracer=tobs.Tracer(), **kw)
    assert _serve(off, plan) == _serve(on, plan)
    assert on.host_syncs == off.host_syncs
    assert on.pipeline_flushes == off.pipeline_flushes
    assert on.decode_steps == off.decode_steps


# ---------------------------------------------------------------------------
# the HTTP surface, read by tools/metrics_dump.py
# ---------------------------------------------------------------------------
def test_http_observability_endpoints_and_metrics_dump(models, capsys):
    import urllib.error
    import urllib.request
    _, tcfg, _, tparams = models
    md = _md()
    cache = tpd.PagedKVCache(tcfg, device="cpu", **CACHE)
    srv = GenerationServer(tcfg, tparams, cache)
    assert srv.tracer is not None and srv.engine.tracer is srv.tracer
    srv.tracer.store.keep_slower_than_ms = 0.0
    port = srv.start()
    url = f"http://127.0.0.1:{port}"

    def get(path):
        return urllib.request.urlopen(url + path, timeout=60).read()

    try:
        toks = generate_http(url, [5, 6, 7, 8], max_new_tokens=4)
        streamed = list(generate_http_stream(url, [9, 10], 3))
        assert len(toks) == 4 and len(streamed) == 3
        text = get("/metrics").decode()
        assert "# TYPE paddle_tpu_engine_decode_steps_total counter" in text
        assert "paddle_tpu_engine_requests_finished_total 2" in text
        assert "paddle_tpu_http_generate_requests_total 2" in text
        assert "paddle_tpu_request_ttft_seconds_count 2" in text
        stats = json.loads(get("/stats"))
        assert stats["events_buffered"] == len(srv.ring)
        m = stats["metrics"]
        assert m["paddle_tpu_trace_retained_total"]["value"] == 2
        assert m["paddle_tpu_request_ttft_seconds"]["exemplars"]["last"][
            "trace_id"] == "1"
        health = json.loads(get("/health"))
        assert health["requests_finished"] == 2 and health["ready"]
        assert health["tokens_generated"] == 5 and health["active"] == 0
        for key in ("occupancy", "restarts", "step_faults", "host_syncs",
                    "pipeline_flushes", "decode_horizon", "mixed_ticks"):
            assert key in health
        evs = json.loads(get("/events?n=3"))
        assert len(evs["events"]) == 3 and evs["gap"] == 0
        follow = json.loads(get("/events?since=1"))["events"]
        assert [e["seq"] for e in follow] == list(range(2, len(srv.ring)
                                                        + 1))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/events?n=x")
        assert ei.value.code == 400
        idx = json.loads(get("/traces?limit=5"))["traces"]
        assert [t["trace_id"] for t in idx] == ["1", "0"]
        assert json.loads(get("/traces?status=cancelled"))["traces"] == []
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/trace/424242")
        assert ei.value.code == 404

        class A:
            n = 50
            follow = False
            interval = 0.0
            min_ms = 0.0
            status = None
            limit = 10
            rid = "0"

        A.url = url
        capsys.readouterr()
        assert md.cmd_metrics(A()) == 0
        assert capsys.readouterr().out == text
        assert md.cmd_stats(A()) == 0
        out = capsys.readouterr().out
        assert "paddle_tpu_engine_requests_finished_total" in out
        assert "histogram  count=2" in out
        assert md.cmd_events(A()) == 0
        lines = capsys.readouterr().out.splitlines()
        names = [json.loads(ln)["name"] for ln in lines]
        assert names.count("request_submitted") == 2
        assert names.count("request_finished") == 2
        assert md.cmd_traces(A()) == 0
        out = capsys.readouterr().out
        assert "duration_ms" in out and "ok" in out
        assert md.cmd_trace(A()) == 0
        out = capsys.readouterr().out
        assert "trace 0" in out and "status=ok" in out
        assert "decode_active" in out and "phase clocks" in out
        assert "http_ingress" in out and "stream" in out
    finally:
        srv.stop()


@pytest.mark.mixed
def test_mixed_health_view_equals_jax(models):
    """``/health``'s mixed keys (``mixed_budget_utilization`` by JAX's
    formula, parked rows counted active) from the registry view equal
    JAX's server's view of JAX's mixed engine, and the engine-attribute
    view agrees."""
    import paddle_tpu.inference.serving as jsrv
    kw, ck, plan_fn = LANES["mixed_overlap"]
    plan = plan_fn()
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jeng = _jax_engine(models, jreg, ck, **kw)
    teng = _port_engine(models, treg, ck, **kw)
    # a parked row mid-service, then the drain
    for eng in (jeng, teng):
        for p, n in plan[0]:
            eng.submit(p, max_new_tokens=n)
        while not eng._mixed_pref:
            eng.step()
    assert teng.mixed_ticks == jeng.mixed_ticks
    views = []
    for _ in range(2):
        th = GenerationServer._health_from_registry(
            treg.snapshot(), 1, teng.mixed_token_budget)
        jh = jsrv.GenerationServer._health_from_registry(
            True, True, None, 0, jreg, 0, None, jeng.mixed_token_budget, 1)
        for key in ("mixed_ticks", "mixed_prefill_tokens",
                    "mixed_budget_utilization", "active", "queued",
                    "queued_tokens", "decode_steps", "prefill_calls"):
            assert th[key] == jh[key], key
        te = GenerationServer._health_from_engine(teng)
        for key in ("mixed_ticks", "mixed_prefill_tokens",
                    "mixed_budget_utilization", "active", "queued_tokens"):
            assert te[key] == th[key], key
        views.append(th)
        jeng.run_to_completion()
        teng.run_to_completion()
    mid, end = views
    assert mid["active"] == 2                # one decoding, one parked
    assert 0 < end["mixed_budget_utilization"] <= 1
    assert end["mixed_budget_utilization"] == round(
        teng.mixed_prefill_tokens
        / (teng.mixed_ticks * teng.mixed_token_budget), 4)


def test_health_without_a_registry_reads_the_engine(models):
    _, tcfg, _, tparams = models
    cache = tpd.PagedKVCache(tcfg, device="cpu", **CACHE)
    srv = GenerationServer(tcfg, tparams, cache, metrics_registry=False,
                           tracer=False)
    assert srv.tracer is None and srv.registry.names() == \
        ["paddle_tpu_http_generate_requests_total",
         "paddle_tpu_http_predict_requests_total"]
    port = srv.start()
    url = f"http://127.0.0.1:{port}"
    try:
        generate_http(url, [1, 2, 3], max_new_tokens=3)
        h = srv.health_snapshot()
        eng = srv.engine
        assert h["requests_finished"] == 1
        assert h["decode_steps"] == eng.decode_steps
        assert h["tokens_generated"] == eng.tokens_generated == 2
        assert h["host_syncs"] == eng.host_syncs
        assert "occupancy" not in h
        import urllib.error
        import urllib.request
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/traces")
        assert ei.value.code == 404
    finally:
        srv.stop()
