"""Per-request tracing in the port (``paddle_tpu_torch.observability.tracing``
and its wiring through the port's engine and server), held against
paddle_tpu's on the 2-layer fp32 config of ``tests/test_tracing.py`` with
the same weights (``params_from_jax``).

* The ``TraceStore`` makes JAX's retention decisions on the same sequence
  of traces: tail sampling, the FIFO bound, the live-table bound, re-keyed
  colliding ids and late spans.
* A served request's phase clocks chain gaplessly from submit to finish
  (their sum is the wall time within 1e-6), the trace-derived TTFT and
  queue wait agree with the histograms, whose exemplars name the trace;
  the port's span names per request equal JAX's engine's on the same
  prompts.
* Tracing changes no token, on the packed, overlap and horizon lanes.
* Preempted, cancelled and expired requests keep their spans, and tail
  retention keeps the abnormal ones.
* The server's ``/traces``, ``/trace/<rid>`` (JSON and Perfetto) and 404,
  the adoption of an engine's own tracer, and ``tools/metrics_dump.py``'s
  trace renderers on a port trace.

* Requests a supervisor restart kills close their traces with status
  ``error``, keeping their phase spans, as in JAX.

* The mixed lane (``mixed=True``): span names equal to JAX's mixed
  engine's, tracing token-exact, and the phase clocks of rows parked
  mid-prefill chaining gaplessly.

JAX's swap case (the ``swapped`` phase and the ``swap_in`` span) is held in
``tests/test_torch_serving_swap.py``; its disaggregation, fleet failover
and remote-replica cases wait for their lanes (ROADMAP.md).
"""

import importlib
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http)
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
CACHE = dict(num_pages=64, pages_max=8, batch=2, page=16)
_RNG = np.random.RandomState(13)
PROMPTS = [[int(t) for t in _RNG.randint(1, 128, (L,))]
           for L in (10, 21, 33, 8)]


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


def _keep_all(obs=tobs):
    return obs.Tracer(obs.TraceStore(keep_slower_than_ms=0.0))


def _engine(models, tracer=None, registry=False, cache_kw=None, **kw):
    _, tcfg, _, tparams = models
    cache = tpd.PagedKVCache(tcfg, device="cpu",
                             **dict(CACHE, **(cache_kw or {})))
    return ContinuousBatchingEngine(tcfg, tparams, cache,
                                    metrics_registry=registry,
                                    tracer=tracer, **kw)


def _jax_engine(models, tracer=None, registry=False, cache_kw=None, **kw):
    jcfg, _, jparams, _ = models
    cache = jpd.PagedKVCache(jcfg, **dict(CACHE, **(cache_kw or {})))
    return jse.ContinuousBatchingEngine(jcfg, jparams, cache,
                                        metrics_registry=registry,
                                        tracer=tracer, **kw)


def _phase_spans(doc, phases=tobs.PHASES):
    return [s for s in doc["spans"] if s["name"] in phases]


def _assert_gapless(req):
    """The closed phase intervals chain from submit to finish."""
    log = req.phase_log
    assert log[0][1] == req.t_submit and log[-1][2] == req.t_finish
    for (_, _, t1), (_, t0, _) in zip(log, log[1:]):
        assert t1 == t0
    clocks = tobs.phase_clocks(req)
    wall = req.t_finish - req.t_submit
    assert abs(sum(clocks.values()) - wall) <= 1e-6 * max(wall, 1e-3)
    return clocks


# ---------------------------------------------------------------------------
# the store's retention against JAX's
# ---------------------------------------------------------------------------
def _retention_run(obs):
    """tests/test_tracing.py's retention scenarios, on one package ->
    every decision and reading, free of clocks."""
    store = obs.TraceStore(capacity=64, keep_slower_than_ms=100.0,
                           sample_every=4)
    tr = obs.Tracer(store)

    def finish(i, status="ok", slow=False, **attrs):
        ctx = tr.begin_trace(f"t{i}", **attrs)
        if slow:
            with tr._lock:
                tr._live[ctx.trace_id]["t0"] -= 1.0
        return ctx.close(status=status)

    out = {"fast": [finish(i) for i in range(8)],
           "abnormal": [finish(i, status=s) for i, s in
                        enumerate(("error", "cancelled", "expired",
                                   "faulted"), start=100)],
           "slow": finish(200, slow=True),
           "failover": finish(201, failovers=1),
           "forced": finish(202, force_keep=True),
           "rejected": [finish(i, status="rejected")
                        for i in range(300, 306)]}
    st = store.stats()
    out["stats"] = {k: st[k] for k in ("traces", "retained", "sampled_out",
                                       "evicted")}
    out["kept"] = sorted(t["trace_id"] for t in store.index(limit=100))
    out["errors"] = [t["trace_id"] for t in store.index(status="error")]
    out["slow_idx"] = [t["trace_id"] for t in store.index(min_ms=100.0)]
    # the FIFO bound and the live-table bound
    small = obs.TraceStore(capacity=3, keep_slower_than_ms=0.0)
    tr2 = obs.Tracer(small, max_live=4)
    for i in range(5):
        tr2.begin_trace(f"f{i}").close()
    out["fifo"] = [small.get(f"f{i}") is not None for i in range(5)]
    ctxs = [tr2.begin_trace(f"live{i}") for i in range(6)]
    out["abandoned"] = sorted(t["trace_id"]
                              for t in small.index(status="abandoned"))
    out["live_index"] = [t["trace_id"]
                         for t in tr2.index(status="live", limit=10)]
    out["in_flight"] = tr2.get(ctxs[-1].trace_id)["in_flight"]
    out["small_stats"] = {k: v for k, v in small.stats().items()
                          if k != "approx_bytes"}
    out["dup"] = [tr2.begin_trace("dup").trace_id,
                  tr2.begin_trace("dup").trace_id]
    # re-keyed collisions in one store shared by two tracers
    shared = obs.TraceStore(keep_slower_than_ms=0.0)
    obs.Tracer(shared).begin_trace("1", front="a").close()
    obs.Tracer(shared).begin_trace("1", front="b").close()
    tr3 = obs.Tracer(shared)
    tr3.begin_trace("7").close(status="rejected", error="x")
    tr3.begin_trace("7").close()
    out["rekeyed"] = [shared.get("1")["attrs"]["front"],
                      shared.get("1#1")["attrs"]["front"],
                      shared.get("7#1")["status"], len(shared)]
    # late spans land only on retained traces
    out["late"] = [tr3.add_span("7", "stream", 0.0, 0.1),
                   tr3.add_span("never-begun", "stream", 0.0, 0.1),
                   [s["name"] for s in shared.get("7")["spans"]]]
    # closing twice is harmless; the store's metrics
    reg = obs.MetricsRegistry()
    st2 = obs.TraceStore(sample_every=2, metrics_registry=reg)
    tr4 = obs.Tracer(st2)
    ctx = tr4.begin_trace("m")
    out["close_twice"] = [ctx.close(), ctx.close()]
    for i in range(3):
        tr4.begin_trace(f"m{i}").close()
    out["store_metrics"] = reg.render_prometheus()
    return out


def test_trace_store_retention_equals_jax():
    got, want = _retention_run(tobs), _retention_run(jobs)
    assert got == want
    # and the decisions are the documented ones
    assert got["fast"] == [True, False, False, False] * 2
    assert got["abnormal"] == [True] * 4
    assert got["slow"] and got["failover"] and got["forced"]
    assert got["rejected"].count(True) == 2
    assert got["fifo"] == [False, False, True, True, True]
    assert got["dup"] == ["dup", "dup#1"]
    assert got["rekeyed"] == ["b", "a", "rejected", 4]


def test_chrome_trace_for_merges_the_ring():
    tr = _keep_all()
    ctx = tr.begin_trace("9")
    ctx.span("queued", 1.0, 1.5, phase="queued")
    ctx.close()
    ring = tobs.EventRing()
    ring.emit("request_submitted", rid=9)
    doc = tr.export_chrome_trace("9", ring=ring)
    names = [e["name"] for e in doc["traceEvents"]]
    assert names == ["request", "queued", "request_submitted"]
    q = doc["traceEvents"][1]
    assert q["dur"] == pytest.approx(0.5e6)
    assert q["args"]["trace_id"] == "9" and q["args"]["parent"] == 0
    assert tr.export_chrome_trace("nope") is None


# ---------------------------------------------------------------------------
# the engine: span accounting, exemplars, exactness
# ---------------------------------------------------------------------------
def test_phase_clocks_sum_to_wall_and_match_histograms(models):
    reg = tobs.MetricsRegistry()
    tr = _keep_all()
    eng = _engine(models, tracer=tr, registry=reg)
    rid = eng.submit(PROMPTS[0], max_new_tokens=6)
    req = next(r for r in eng.run_to_completion() if r.rid == rid)
    clocks = _assert_gapless(req)
    assert set(clocks) <= set(tobs.PHASES)
    assert clocks["decode_active"] > 0 and clocks["prefill"] > 0
    derived = clocks["queued"] + clocks["prefill"]
    snap = reg.snapshot()
    ttft = snap["paddle_tpu_request_ttft_seconds"]
    qw = snap["paddle_tpu_request_queue_wait_seconds"]
    assert abs(derived - ttft["sum"]) < 0.05
    assert abs(derived - qw["sum"]) < 0.05
    assert ttft["exemplars"]["max"]["trace_id"] == str(rid)
    assert qw["exemplars"]["last"]["trace_id"] == str(rid)
    tpot = snap["paddle_tpu_request_tpot_seconds"]
    assert tpot["exemplars"]["max"]["trace_id"] == str(rid)
    doc = tr.get(str(rid))
    assert doc["status"] == "ok" and not doc.get("in_flight")
    assert doc["spans"][0]["name"] == "request"
    assert doc["attrs"]["tokens"] == len(req.generated) == 6
    assert doc["attrs"]["prompt_len"] == len(PROMPTS[0])
    by_phase = {}
    for s in _phase_spans(doc):
        by_phase[s["name"]] = by_phase.get(s["name"], 0.0) + s["dur_s"]
    assert by_phase == pytest.approx(clocks, abs=1e-9)
    assert doc["attrs"]["clocks"] == clocks
    assert tr.index(status="live") == []


LANES = {"packed": ({}, {}),
         "batched": ({"packed": False}, {}),
         "overlap": ({"overlap": True}, {"batch": 4}),
         "horizon4": ({"decode_horizon": 4}, {"batch": 4}),
         "preemption": ({}, {"num_pages": 5, "pages_max": 4}),
         # batch 2: two prompts admit in the cold wave, two park and ride
         # the mixed ticks
         "mixed": ({"mixed": True, "mixed_token_budget": 16}, {})}


def _lane_prompts(lane):
    if lane == "preemption":
        rng = np.random.RandomState(7)
        return [([int(t) for t in rng.randint(1, 128, (16,))], 20)
                for _ in range(2)]
    return [(p, 8) for p in PROMPTS]


@pytest.mark.parametrize("lane", list(LANES))
def test_span_names_equal_jax(models, lane):
    """Per request, the port's trace holds JAX's spans in JAX's order and
    closes with JAX's status and attrs (clocks aside)."""
    kw, ck = LANES[lane]
    docs = []
    for make, obs in ((_jax_engine, jobs), (_engine, tobs)):
        tr = _keep_all(obs)
        eng = make(models, tracer=tr, cache_kw=ck, **kw)
        rids = [eng.submit(p, max_new_tokens=n) for p, n in
                _lane_prompts(lane)]
        done = {r.rid: r for r in eng.run_to_completion()}
        for rid in rids:
            _assert_gapless(done[rid])
        docs.append([tr.get(str(r)) for r in rids])
    for j, t in zip(*docs):
        assert [s["name"] for s in t["spans"]] == \
            [s["name"] for s in j["spans"]]
        assert [s["attrs"] for s in t["spans"][1:]] == \
            [s["attrs"] for s in j["spans"][1:]]
        assert t["status"] == j["status"]
        ta = {k: v for k, v in t["attrs"].items() if k != "clocks"}
        ja = {k: v for k, v in j["attrs"].items() if k != "clocks"}
        assert ta == ja
        assert set(t["attrs"]["clocks"]) == set(j["attrs"]["clocks"])


@pytest.mark.parametrize("lane", ["packed", "overlap", "horizon4", "mixed"])
def test_tracing_is_token_exact(models, lane):
    kw, ck = LANES[lane]

    def run(tracer):
        eng = _engine(models, tracer=tracer, cache_kw=ck, **kw)
        rids = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        done = {r.rid: list(r.generated) for r in eng.run_to_completion()}
        eng.cache.audit()
        return [done[r] for r in rids], eng.host_syncs

    assert run(None) == run(_keep_all())


@pytest.mark.mixed
@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_lane_phase_accounting(models, overlap):
    """JAX's case: rows parked mid-prefill on the mixed lane keep phase
    clocks that chain submit -> finish and sum to the wall.  One request
    decodes first, so the others park and ride mixed ticks."""
    tr = _keep_all()
    eng = _engine(models, tracer=tr, cache_kw={"batch": 4}, mixed=True,
                  mixed_token_budget=16, overlap=overlap)
    rids = [eng.submit(PROMPTS[0], max_new_tokens=6)]
    eng.step()
    rids += [eng.submit(p, max_new_tokens=6) for p in PROMPTS[1:]]
    done = {r.rid: r for r in eng.run_to_completion()}
    assert eng.mixed_ticks > 0
    for rid in rids:
        clocks = _assert_gapless(done[rid])
        assert clocks.get("decode_active", 0) > 0
        assert clocks.get("prefill", 0) > 0
        assert tr.get(str(rid))["status"] == "ok"
    eng.cache.audit()


@pytest.mark.parametrize("overlap", [False, True])
def test_preemption_spans_and_clocks(models, overlap):
    tr = _keep_all()
    eng = _engine(models, tracer=tr, overlap=overlap,
                  cache_kw={"num_pages": 5, "pages_max": 4})
    for p, n in _lane_prompts("preemption"):
        eng.submit(p, max_new_tokens=n)
    done = {r.rid: r for r in eng.run_to_completion()}
    assert eng.preemptions >= 1
    victim = next(r for r in done.values() if r.preempted)
    clocks = _assert_gapless(victim)
    assert clocks.get("preempted", 0) > 0
    doc = tr.get(str(victim.rid))
    names = [s["name"] for s in doc["spans"]]
    assert "preempt" in names and "preempted" in names
    assert names.count("prefill") == 1 + victim.preempted
    pre = next(s for s in doc["spans"] if s["name"] == "preempt")
    assert pre["attrs"]["mode"] == "recompute"
    assert doc["attrs"]["preemptions"] == victim.preempted
    eng.cache.audit()


def test_cancelled_and_expired_traces_always_kept(models):
    tr = tobs.Tracer(tobs.TraceStore(keep_slower_than_ms=1e12,
                                     sample_every=10**6))
    tr.store._n_ok = 1      # burn the sampler's keep-the-first slot
    eng = _engine(models, tracer=tr, cache_kw={"batch": 4})
    ok = eng.submit(PROMPTS[0], max_new_tokens=4)
    gone = eng.submit(PROMPTS[1], max_new_tokens=50)
    late = eng.submit(PROMPTS[2], max_new_tokens=50, deadline_s=0.0)
    eng.cancel(gone)
    done = {r.rid: r for r in eng.run_to_completion()}
    assert done[gone].status == "cancelled"
    assert done[late].status == "expired"
    assert tr.get(str(gone))["status"] == "cancelled"
    assert tr.get(str(late))["status"] == "expired"
    # a request cancelled in the queue still accounts its wall
    assert [s["name"] for s in _phase_spans(tr.get(str(gone)))] == \
        ["queued"]
    _assert_gapless(done[gone])
    assert tr.get(str(ok)) is None            # sampled out, as asked
    st = tr.store.stats()
    assert st["retained"] == 2 and st["sampled_out"] >= 1
    eng.cache.audit()


def test_active_cancel_keeps_its_decode_spans(models):
    tr = _keep_all()
    eng = _engine(models, tracer=tr, overlap=True, cache_kw={"batch": 4})
    rid = eng.submit(PROMPTS[1], max_new_tokens=50)
    for _ in range(3):
        eng.step()
    eng.cancel(rid)
    done = {r.rid: r for r in eng.run_to_completion()}
    assert done[rid].status == "cancelled"
    _assert_gapless(done[rid])
    doc = tr.get(str(rid))
    assert doc["status"] == "cancelled"
    assert [s["name"] for s in _phase_spans(doc)] == \
        ["queued", "prefill", "decode_active"]
    eng.cache.audit()


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------
def test_generation_server_trace_endpoints(models):
    _, tcfg, _, tparams = models
    srv = GenerationServer(tcfg, tparams,
                           tpd.PagedKVCache(tcfg, device="cpu", **CACHE))
    assert srv.tracer is not None             # on by default
    srv.tracer.store.keep_slower_than_ms = 0.0
    port = srv.start()
    url = f"http://127.0.0.1:{port}"
    try:
        toks = generate_http(url, [5, 6, 7, 8], max_new_tokens=4)
        assert len(toks) == 4
        idx = json.loads(urllib.request.urlopen(
            url + "/traces").read())["traces"]
        assert idx and idx[0]["status"] == "ok"
        rid = idx[0]["trace_id"]
        doc = json.loads(urllib.request.urlopen(
            url + f"/trace/{rid}").read())
        names = [s["name"] for s in doc["spans"]]
        for must in ("request", "http_ingress", "queued", "prefill",
                     "decode_active", "stream"):
            assert must in names, (must, names)
        stream = next(s for s in doc["spans"] if s["name"] == "stream")
        assert stream["attrs"] == {"phase": "stream", "status": "ok"}
        perf = json.loads(urllib.request.urlopen(
            url + f"/trace/{rid}?format=perfetto").read())
        evnames = {e["name"] for e in perf["traceEvents"]}
        assert "decode_active" in evnames
        assert "request_submitted" in evnames     # ring event
        stats = json.loads(urllib.request.urlopen(
            url + "/stats").read())["metrics"]
        ex = stats["paddle_tpu_request_ttft_seconds"]["exemplars"]
        assert ex["max"]["trace_id"] == rid
        assert "paddle_tpu_trace_retained_total" in stats
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/trace/424242")
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/traces?limit=x")
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_server_adopts_the_engines_own_tracer(models):
    tr = _keep_all()
    eng = _engine(models, tracer=tr)
    srv = GenerationServer(engine=eng)
    assert srv.tracer is tr
    assert srv.registry.get("paddle_tpu_trace_retained_total") is not None
    rid, _ = srv.submit([1, 2, 3], 2)
    eng.run_to_completion()
    names = [s["name"] for s in tr.get(str(rid))["spans"]]
    assert "http_ingress" in names    # ingress landed on the real trace
    off = GenerationServer(engine=_engine(models), tracer=False)
    assert off.tracer is None and off.engine.tracer is None


def test_metrics_dump_trace_renderers(models, capsys):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    try:
        md = importlib.import_module("metrics_dump")
    finally:
        sys.path.pop(0)
    tr = _keep_all()
    eng = _engine(models, tracer=tr)
    rid = eng.submit(PROMPTS[0], max_new_tokens=4)
    eng.run_to_completion()
    text = md._render_trace(tr.get(str(rid)))
    assert f"trace {rid}" in text and "status=ok" in text
    assert "decode_active" in text and "phase clocks" in text
    body = json.dumps({"traces": tr.index(limit=10)}).encode()
    md_get, md._get = md._get, lambda url, timeout=10.0: body
    try:
        class A:
            url = "http://x"
            min_ms = 0.0
            status = None
            limit = 10

        assert md.cmd_traces(A()) == 0
    finally:
        md._get = md_get
    out = capsys.readouterr().out
    assert str(rid) in out and "duration_ms" in out


def test_supervisor_restart_faults_close_traces(models):
    """Requests killed by an engine rebuild still close their traces
    (status error, their phase spans kept): retirement is not the only
    trace exit.  The same span names and status as JAX's supervisor."""
    docs = {}
    for side, obs, mod, fmod, build in (
            ("jax", jobs, jse, jfaults, _jax_engine),
            ("port", tobs, tse, tfaults, _engine)):
        tr = _keep_all(obs)
        sup = mod.EngineSupervisor(
            lambda build=build, tr=tr: build(models, tracer=tr,
                                             quarantine_faults=False),
            backoff_s=0.0)
        rid = sup.submit(PROMPTS[0], max_new_tokens=30)
        sup.step()                            # admit + decode once
        with fmod.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("boom"), nth=1,
                      times=1)
            sup.step()                        # escapes -> restart
        done = {r.rid: r for r in sup.finished()}
        assert done[rid].status == "error"
        assert done[rid].error == "RuntimeError: boom"
        assert sup.restarts == 1
        doc = tr.get(str(rid))
        assert doc is not None and doc["status"] == "error"
        assert tr.index(status="live") == []
        docs[side] = doc
    names = [s["name"] for s in docs["port"]["spans"]]
    assert "decode_active" in names
    assert names == [s["name"] for s in docs["jax"]["spans"]]
    assert docs["port"]["error"] == docs["jax"]["error"]
