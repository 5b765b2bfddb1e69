"""Fault-tolerant serving in the port (``paddle_tpu_torch/testing/faults.py``,
the engine's wave quarantine, ``EngineSupervisor`` and the HTTP front's
fault paths), held against paddle_tpu's on the 2-layer fp32 config of
``tests/test_serving_faults.py`` with the same weights (``params_from_jax``)
and no host page tier on either side.

Each case arms JAX's plane and the port's plane (separate modules) with the
same rule and runs the same requests through both engines.  Then each
rid's status, error text and tokens, ``step_faults``, ``requests_faulted``,
``_consecutive_faults``, the registry's fault counters, every ring event
(``engine_quarantine`` and ``engine_restart`` among them; every field but
the clocks) and ``cache.audit()`` must be equal, and the pool clean:

* the plane: the same seed and rules match the same consults in both;
* a step fault on the sync, overlap, horizon-2, horizon-4 and
  overlap + horizon-4 lanes quarantines exactly the wave it poisoned,
  in flight or not, and the queue then serves;
* an admission fault on the packed, batched and chunked lanes, and on the
  packed lane with a prefix hit, fails the popped wave loudly;
* consecutive faults escalate;
* the supervisor transplants the queue, fails an admission-phase death's
  wave loudly and runs out of budget; its lifecycle verbs; a rebuild over
  the same cache keeps the decode graphs, one over another cache drops
  the dead engine's;
* HTTP: an engine death's text reaches 500 and 503 replies, a supervised
  server recovers, ``/health``'s ``step_faults`` / ``restarts`` equal JAX's
  server's, and a ``stream_write`` disconnect cancels the request.

* a fault at a mixed tick (``mixed=True``, sync and overlap) quarantines
  the rows parked mid-prefill with the decode rows.

The swap sites (``swap_in``, ``swap_out``, ``host_pool_full``) are held in
``tests/test_torch_serving_swap.py``; the fleet and transport sites wait
for their lanes (ROADMAP.md).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu.inference.serving as jsrv  # noqa: E402
import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu_torch.inference.serving as tsrv  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
CACHE = dict(num_pages=64, pages_max=8, batch=2, page=16, host_pages=0)
PROMPTS = np.random.RandomState(77).randint(1, 128, (4, 10))
CLOCK_FIELDS = ("ts", "wall", "tid", "dur_s")

LANES = {"sync": {}, "overlap": {"overlap": True},
         "horizon2": {"decode_horizon": 2},
         "horizon4": {"decode_horizon": 4},
         "overlap_horizon4": {"overlap": True, "decode_horizon": 4}}
ADMIT_LANES = {"packed": {}, "batched": {"packed": False},
               "chunked": {"packed": False, "prefill_chunk": 32}}


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


# each side: (engine module, cache module, fault plane, observability,
# server module)
SIDES = {"jax": (jse, jpd, jfaults, jobs, jsrv),
         "port": (tse, tpd, tfaults, tobs, tsrv)}


def _cache(models, side, **kw):
    jcfg, tcfg = models[:2]
    if side == "jax":
        return jpd.PagedKVCache(jcfg, **dict(CACHE, **kw))
    return tpd.PagedKVCache(tcfg, device="cpu", **dict(CACHE, **kw))


def _engine(models, side, cache=None, **kw):
    jcfg, tcfg, jparams, tparams = models
    cache = cache if cache is not None else _cache(models, side)
    if side == "jax":
        return jse.ContinuousBatchingEngine(jcfg, jparams, cache, **kw)
    return tse.ContinuousBatchingEngine(tcfg, tparams, cache, **kw)


def _events(ring):
    return [{k: v for k, v in e.items() if k not in CLOCK_FIELDS}
            for e in ring.recent()]


def _by_rid(done):
    return {r.rid: (r.status, r.error, [int(t) for t in r.generated])
            for r in done}


def _run(side, eng, rules, prompts=PROMPTS, new=12):
    """Submit ``prompts`` and drive ``eng`` to the end under a plane of
    ``side`` armed with ``rules`` ((site, exc, kwargs) each)."""
    with SIDES[side][2].plane() as fp:
        for site, exc, kw in rules:
            fp.inject(site, exc, **kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        done = eng.run_to_completion()
    return _by_rid(done)


def _assert_same_audit(tcache, jcache):
    """The port's audit equals JAX's (JAX's also counts swap records, of
    a host tier the port does not have: 0 here)."""
    t, j = tcache.audit(), jcache.audit()
    assert j.pop("swap_records", 0) == 0
    assert t == j


def _assert_same_engines(j, t):
    assert t.step_faults == j.step_faults
    assert t.requests_faulted == j.requests_faulted
    assert t._consecutive_faults == j._consecutive_faults
    assert t.last_fault == j.last_fault
    for name in ("requests_faulted", "requests_cancelled",
                 "requests_finished", "engine_restarts"):
        assert getattr(t.metrics, name).value == \
            getattr(j.metrics, name).value, name
    assert t.metrics.requests_faulted.value == t.requests_faulted
    assert _events(t.metrics.ring) == _events(j.metrics.ring)
    _assert_same_audit(t.cache, j.cache)
    assert t.cache.audit()["owned"] == 0
    assert len(t._free_slots) == t.B and not t._admitting


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------
def _consults(fmod, seed):
    """Every kind of rule on one plane -> which consults matched."""
    fp = fmod.FaultPlane()
    fp.inject("every", RuntimeError("x"), every=3)
    fp.inject("nth", ValueError("y"), nth=2)
    fp.inject("times", RuntimeError("z"), times=2)
    fp.inject("p", p=0.5, seed=seed)
    fp.inject("p_exc", KeyError("w"), p=0.3, seed=seed + 1, times=3)
    out = {}
    for site in ("every", "nth", "times", "p_exc"):
        hits = []
        for _ in range(12):
            try:
                fp.fire(site)
                hits.append(False)
            except Exception as e:
                hits.append(type(e).__name__)
        out[site] = hits
    out["p"] = [fp.active("p") for _ in range(40)]
    fp.clear("every")
    fp.fire("every")
    out["counts"], out["fired"] = dict(fp.counts), dict(fp.fired)
    return out


@pytest.mark.parametrize("seed", [0, 7, 8])
def test_fault_plane_matches_jax(seed):
    assert _consults(tfaults, seed) == _consults(jfaults, seed)
    assert tfaults.get() is None
    tfaults.fire("anything")
    assert tfaults.active("anything") is False
    # the two planes are separate: installing one arms nothing in the other
    with tfaults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("port only"))
        assert jfaults.get() is None
        with pytest.raises(RuntimeError, match="port only"):
            tfaults.fire("step_dispatch")
    assert tfaults.get() is None


# ---------------------------------------------------------------------------
# step-fault quarantine, every decode lane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", list(LANES))
def test_step_fault_quarantines_its_wave_as_jax(models, lane):
    """The second decode dispatch raises (on the overlap lanes with the
    first still in flight): the first wave of two retires with the text,
    the queued two then serve, and everything equals JAX's engine."""
    rule = [("step_dispatch", RuntimeError("injected step fault"),
             {"nth": 2})]
    res = {}
    for side in SIDES:
        eng = _engine(models, side, **LANES[lane])
        res[side] = (eng, _run(side, eng, rule))
    (j, jout), (t, tout) = res["jax"], res["port"]
    assert tout == jout
    assert [tout[r][0] for r in range(4)] == ["error", "error", "ok", "ok"]
    assert tout[0][1] == "RuntimeError: injected step fault"
    assert t.step_faults == 1 and t.requests_faulted == 2
    assert not t._inflight and t._dev is None
    _assert_same_engines(j, t)
    ev = [e for e in _events(t.metrics.ring)
          if e["name"] == "engine_quarantine"]
    assert ev == [{"name": "engine_quarantine", "seq": ev[0]["seq"],
                   "error": "RuntimeError: injected step fault",
                   "consecutive": 1}]


@pytest.mark.mixed
@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_tick_fault_quarantines_parked_rows_as_jax(models, overlap):
    """The mixed lane's ``step_dispatch`` site: a resident request decodes,
    a 40-token prompt parks (``mixed_token_budget=16``: three ticks) and a
    third waits for a slot; the first mixed tick raises.  The decode row
    and the parked row retire with the text, the third then serves, the
    pool comes back clean, as in JAX's mixed engine."""
    rng = np.random.RandomState(9)
    first, long_, last = (rng.randint(1, 128, n) for n in (10, 40, 10))
    res = {}
    for side in SIDES:
        eng = _engine(models, side, mixed=True, mixed_token_budget=16,
                      overlap=overlap)
        with SIDES[side][2].plane() as fp:
            fp.inject("step_dispatch", RuntimeError("injected mixed fault"),
                      nth=2)
            eng.submit(first, max_new_tokens=12)
            eng.step()                        # the cold wave, dispatch 1
            eng.submit(long_, max_new_tokens=6)
            eng.submit(last, max_new_tokens=6)
            eng.step()                        # parks long_; tick raises
            assert not eng._mixed_pref and eng.step_faults == 1
            res[side] = (eng, _by_rid(eng.run_to_completion()))
    (j, jout), (t, tout) = res["jax"], res["port"]
    assert tout == jout
    assert [tout[r][0] for r in range(3)] == ["error", "error", "ok"]
    assert tout[1][1] == "RuntimeError: injected mixed fault"
    assert t.requests_faulted == 2 and t.mixed_ticks == j.mixed_ticks
    assert not t._inflight and t._dev is None
    _assert_same_engines(j, t)


@pytest.mark.parametrize("lane", list(ADMIT_LANES) + ["packed_prefix_hit"])
def test_admission_fault_fails_the_wave_loudly_as_jax(models, lane):
    """The first prefill dispatch raises with slots and pages claimed and
    the wave popped off the queue: every popped request ends ``error``
    (none vanishes), the stranded slots and pages come back, the rest of
    the queue serves, as in JAX's engine.  ``packed_prefix_hit``: a warm
    request registers a 2-page prefix that the faulted wave shares."""
    prefix = lane == "packed_prefix_hit"
    kw = ({"enable_prefix_caching": True} if prefix
          else ADMIT_LANES[lane])
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 128, 32)
    prompts = ([np.concatenate([shared, rng.randint(1, 128, n)])
                for n in (3, 9, 20, 5)] if prefix else PROMPTS)
    rule = [("prefill_dispatch", RuntimeError("injected admission fault"),
             {"nth": 1})]
    res = {}
    for side in SIDES:
        eng = _engine(models, side, **kw)
        if prefix:
            eng.submit(np.concatenate([shared, [7, 8]]), max_new_tokens=2)
            eng.run_to_completion()
        res[side] = (eng, _run(side, eng, rule, prompts))
    (j, jout), (t, tout) = res["jax"], res["port"]
    assert tout == jout
    first = min(tout)
    assert sorted(tout) == list(range(first, first + 4))
    errs = [r for r in tout if tout[r][0] == "error"]
    assert errs and all(tout[r][1] == "RuntimeError: injected admission "
                        "fault" for r in errs)
    assert any(v[0] == "ok" for v in tout.values())
    if prefix:
        assert t.cache.prefix_hits == j.cache.prefix_hits > 0
    _assert_same_engines(j, t)


@pytest.mark.parametrize("overlap", [False, True])
def test_consecutive_faults_escalate_as_jax(models, overlap):
    """A fault on every step: two quarantines, then the exception
    escapes (the supervisor's cue)."""
    out = {}
    for side in SIDES:
        eng = _engine(models, side, max_consecutive_faults=2,
                      overlap=overlap)
        with SIDES[side][2].plane() as fp:
            fp.inject("step_dispatch", RuntimeError("persistent"))
            for p in list(PROMPTS) * 2:
                eng.submit(p, max_new_tokens=8)
            eng.step()
            eng.step()
            with pytest.raises(RuntimeError, match="persistent") as ei:
                eng.step()
        out[side] = (eng, str(ei.value), _by_rid(eng.finished()))
    (j, jerr, jdone), (t, terr, tdone) = out["jax"], out["port"]
    assert terr == jerr and tdone == jdone
    assert t.step_faults == 2 and t._consecutive_faults == 3
    assert t.requests_faulted == j.requests_faulted == 4
    assert _events(t.metrics.ring) == _events(j.metrics.ring)
    # the escalated wave is still active: the supervisor releases it
    assert len(t._active) == len(j._active) == 2


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------
def _supervised(models, side, shared_cache=False, **eng_kw):
    """A supervisor whose factory builds engines on one registry and ring
    -> (supervisor, caches built)."""
    obs = SIDES[side][3]
    reg, ring = obs.MetricsRegistry(), obs.EventRing()
    caches = []
    one = _cache(models, side) if shared_cache else None

    def factory():
        cache = one if one is not None else _cache(models, side)
        caches.append(cache)
        return _engine(models, side, cache, metrics_registry=reg,
                       metrics_ring=ring, **eng_kw)

    sup = SIDES[side][0].EngineSupervisor(factory, max_restarts=3,
                                          backoff_s=0.0)
    return sup, caches


@pytest.mark.parametrize("site", ["step_dispatch", "prefill_dispatch"])
def test_supervisor_restart_transplants_the_queue_as_jax(models, site):
    """A dead engine (quarantine off) rebuilds from the factory: the wave
    that died ends ``error`` with the text (an admission-phase death's
    popped wave too), the queued requests move over with their rids and
    serve, and the restart is counted and in the ring, as in JAX."""
    nth = 4 if site == "step_dispatch" else 1
    rule = [(site, RuntimeError("engine death"), {"nth": nth})]
    res = {}
    for side in SIDES:
        sup, caches = _supervised(models, side, quarantine_faults=False)
        res[side] = (sup, caches, _run(side, sup, rule))
    (js, jc, jout), (ts, tc, tout) = res["jax"], res["port"]
    assert tout == jout
    assert sorted(tout) == [0, 1, 2, 3]
    assert [tout[r][0] for r in range(4)] == ["error", "error", "ok", "ok"]
    assert tout[0][1] == "RuntimeError: engine death"
    assert ts.restarts == js.restarts == 1
    assert ts.engine.metrics.engine_restarts.value == 1
    assert ts.engine.requests_faulted == js.engine.requests_faulted == 2
    assert ts.engine.last_fault == "RuntimeError: engine death"
    assert _events(ts.engine.metrics.ring) == _events(js.engine.metrics.ring)
    assert [e["name"] for e in _events(ts.engine.metrics.ring)].count(
        "engine_restart") == 1
    assert len(tc) == len(jc) == 2
    for a, b in zip(tc, jc):
        _assert_same_audit(a, b)


def test_supervisor_budget_exhausted_as_jax(models):
    """Past max_restarts in the window the supervisor gives up with the
    root cause's text and reports DEAD; submits then raise."""
    out = {}
    for side in SIDES:
        eng_mod, _, fmod = SIDES[side][:3]
        sup, _ = _supervised(models, side, quarantine_faults=False)
        sup.max_restarts = 2
        with fmod.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("hard fault"))
            for i in range(2):
                sup.submit(PROMPTS[i], max_new_tokens=8)
                sup.step()
            sup.submit(PROMPTS[2], max_new_tokens=8)
            with pytest.raises(eng_mod.EngineDeadError,
                               match="hard fault") as ei:
                sup.step()
        assert sup.state == "DEAD"
        with pytest.raises(eng_mod.EngineDeadError):
            sup.submit(PROMPTS[0], max_new_tokens=4)
        out[side] = (sup.restarts, str(ei.value),
                     _by_rid(sup.finished()),
                     _events(sup.engine.metrics.ring))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 2


def test_supervisor_lifecycle_as_jax(models):
    """drain() refuses new work while the queued work finishes
    (``drained`` then turns True), resume() opens admission again."""
    seen = {}
    for side in SIDES:
        sup, _ = _supervised(models, side)
        log = [sup.state]
        sup.submit(PROMPTS[0], max_new_tokens=4)
        sup.drain()
        log += [sup.state, sup.drained]
        with pytest.raises(RuntimeError, match="draining"):
            sup.submit(PROMPTS[1], max_new_tokens=4)
        done = sup.run_to_completion()
        log += [sup.drained, _by_rid(done)]
        sup.resume()
        log += [sup.state, sup.drained]
        rid = sup.submit(PROMPTS[1], max_new_tokens=4)
        log += [rid, _by_rid(sup.run_to_completion())]
        seen[side] = log
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == ["READY", "DRAINING", False, True]


@pytest.mark.parametrize("shared_cache", [True, False],
                         ids=["same_cache", "fresh_cache"])
def test_restart_keeps_or_drops_the_decode_graphs(models, shared_cache):
    """Over the same params and cache the rebuilt engine reaches the dead
    engine's decode graphs (one key) and the dead rows are released
    (audit clean); over a fresh cache the dead engine's graphs are
    dropped.  The transplanted requests serve either way."""
    gs.clear()
    try:
        sup, caches = _supervised(models, "port", shared_cache=shared_cache,
                                  quarantine_faults=False, overlap=True)
        sup.submit(PROMPTS[0], max_new_tokens=6)
        sup.run_to_completion()
        before = gs.graphs()
        assert len(before) == 1
        with tfaults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("death"), nth=2)
            for p in PROMPTS:
                sup.submit(p, max_new_tokens=6)
            done = _by_rid(sup.run_to_completion())
        assert sup.restarts == 1
        assert [done[r][0] for r in sorted(done)] == \
            ["error", "error", "ok", "ok"]
        after = gs.graphs()
        if shared_cache:
            assert after == before
        else:
            assert before[0] not in after and len(after) == 1
        for c in caches:
            assert c.audit()["owned"] == 0
    finally:
        gs.clear()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------
def _http(url, data=None, timeout=30):
    try:
        req = urllib.request.Request(url, data=data)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _poll(predicate, timeout_s=60.0):
    t0 = time.monotonic()
    while not predicate():
        assert time.monotonic() - t0 < timeout_s, "condition timeout"
        time.sleep(0.01)


def _body(prompt, new=4):
    return json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": new}).encode()


def _outcomes(queues):
    out = []
    for q in queues:
        while True:
            kind, payload = q.get(timeout=60)
            if kind != "tok":
                out.append((kind, payload))
                break
    return out


def test_http_engine_death_surfaces_its_text(models):
    """Without a factory an escaped exception is fatal: the pending
    request gets 500 with the text, a new one 503 with it, and liveness
    reports the dead loop."""
    srv = tsrv.GenerationServer(engine=_engine(models, "port"))

    def boom():
        raise RuntimeError("induced engine failure xyz")

    srv.engine.step = boom
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        code, text = _http(url + "/generate", _body(PROMPTS[0]))
        assert code == 500 and b"induced engine failure xyz" in text
        code, text = _http(url + "/generate", _body(PROMPTS[0]))
        assert code == 503 and b"induced engine failure xyz" in text
        assert _http(url + "/health/live")[0] == 503
        h = json.loads(_http(url + "/health")[1])
        assert h["status"] == "failed" and "xyz" in h["error"]
    finally:
        srv.stop()


def _servers(models, supervised):
    """JAX's server and the port's, each over its own engine (or factory
    on one registry)."""
    out = {}
    for side in SIDES:
        srv_mod = SIDES[side][4]
        if supervised:
            reg = SIDES[side][3].MetricsRegistry()
            out[side] = srv_mod.GenerationServer(
                engine_factory=lambda side=side, reg=reg: _engine(
                    models, side, quarantine_faults=False,
                    metrics_registry=reg),
                restart_backoff_s=0.0)
        else:
            out[side] = srv_mod.GenerationServer(
                engine=_engine(models, side))
    return out


@pytest.mark.parametrize("supervised", [False, True],
                         ids=["quarantine", "supervisor"])
def test_http_faulted_wave_gets_500_and_health_as_jax(models, supervised):
    """The wave the fourth dispatch poisons gets 500 with the text, the
    queued two 200 with their tokens, new traffic serves afterwards, and
    ``/health``'s step_faults, restarts, requests_faulted and status equal
    JAX's server's (a quarantine, or a supervisor restart)."""
    servers = _servers(models, supervised)
    res = {}
    for side, srv in servers.items():
        fmod = SIDES[side][2]
        with fmod.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("death mid-wave"),
                      nth=4)
            queues = [srv.submit([int(t) for t in p], 8)[1]
                      for p in PROMPTS]
            url = f"http://127.0.0.1:{srv.start()}"
            try:
                got = _outcomes(queues)
                code, text = _http(url + "/generate", _body(PROMPTS[0]))
                h = json.loads(_http(url + "/health")[1])
                ready = _http(url + "/health/ready")[0]
            finally:
                srv.stop()
        res[side] = (got, code, json.loads(text)["tokens"],
                     {k: h[k] for k in ("status", "restarts", "step_faults",
                                        "requests_faulted", "ready")},
                     ready)
    assert res["port"] == res["jax"]
    got, code, _, health, ready = res["port"]
    assert [k for k, _ in got] == ["err", "err", "done", "done"]
    assert got[0][1] == (500, "generation failed: RuntimeError: death "
                              "mid-wave")
    assert code == 200 and ready == 200
    assert health == {"status": "ok", "restarts": int(supervised),
                      "step_faults": int(not supervised),
                      "requests_faulted": 2, "ready": True}
    assert servers["port"].restarts == int(supervised)


def test_http_supervisor_dead_gets_503_and_not_ready(models):
    """A supervisor past its budget ends the drive loop: pending requests
    get 500 with the root cause, new submits 503, readiness false."""
    srv = tsrv.GenerationServer(
        engine_factory=lambda: _engine(models, "port",
                                       quarantine_faults=False),
        max_restarts=1, restart_backoff_s=0.0)
    with tfaults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("every step"))
        queues = [srv.submit([int(t) for t in p], 8)[1] for p in PROMPTS]
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            got = _outcomes(queues)
            assert all(k == "err" and c == 500 and "every step" in t
                       for k, (c, t) in got)
            _poll(lambda: srv._fatal is not None)
            assert "EngineDeadError" in srv._fatal
            code, text = _http(url + "/generate", _body(PROMPTS[0]))
            assert code == 503 and b"every step" in text
            assert _http(url + "/health/ready")[0] == 503
            assert srv.restarts == 1 and srv._supervisor.state == "DEAD"
        finally:
            srv.stop()


def test_http_stream_disconnect_cancels_the_request(models):
    """An injected mid-stream BrokenPipeError (a client that vanished)
    cancels the generation: the cancelled counter moves and the pool
    drains."""
    srv = tsrv.GenerationServer(engine=_engine(models, "port"))
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        with tfaults.plane() as fp:
            rule = fp.inject("stream_write",
                             BrokenPipeError("injected disconnect"), nth=3)
            eng, step = srv.engine, srv.engine.step

            def held_step():
                # the tiny model could finish the request before the
                # handler writes its third chunk: past a few tokens the
                # engine waits for the disconnect
                t0 = time.monotonic()
                while not rule.matches and eng.tokens_generated >= 4 and \
                        time.monotonic() - t0 < 30:
                    time.sleep(0.001)
                return step()

            eng.step = held_step
            try:
                got = list(tsrv.generate_http_stream(
                    url, PROMPTS[0], max_new_tokens=100, timeout=30))
                assert len(got) < 100
            except Exception:
                pass                    # a client-side cutoff is fine
            _poll(lambda: srv.engine.requests_cancelled == 1)
            assert fp.fired["stream_write"] == 1
        with srv._lock:
            assert not srv.engine.has_work()
            assert srv.engine.cache.audit()["owned"] == 0
            assert srv.engine.cache.free_pages() == CACHE["num_pages"] - 1
        h = json.loads(_http(url + "/health")[1])
        assert h["requests_cancelled"] == 1 and h["requests_faulted"] == 0
    finally:
        srv.stop()
