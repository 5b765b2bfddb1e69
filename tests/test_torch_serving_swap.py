"""The host page tier on the port's other lanes, held against paddle_tpu's
on the CPU at the 2-layer fp32 config of ``tests/test_kv_offload.py`` with
the same weights (``params_from_jax``) and the same numpy-seeded requests:

* the decode horizon on the overlap lane (``test_serving_horizon.py``'s
  ``host_pages=16`` case), the mixed tick with swap resumes through the
  carve (``test_serving_mixed.py``'s ``host_pages=48``) and speculative
  decoding with a weak draft (``test_serving_spec.py``'s ``host_pages=32``;
  the target and draft caches both audit clean): tokens equal to the lane's
  reference run and to JAX's engine, the swap and resume counters equal
  JAX's;
* containment (``test_serving_faults.py``): the cancel of a queued swapped
  request, a quarantine under overlap with offload, each of the
  ``swap_out``, ``swap_in`` and ``host_pool_full`` sites degrading to
  recompute, an unexpected ``swap_in`` exception leaking nothing, and the
  supervisor's transplant over a cache with a host tier (a swapped request
  queued at the death resumes recompute-style); every outcome equal to
  JAX's engine's, the pools clean after;
* tracing (``test_tracing.py``): the ``swapped`` phase and the ``swap_in``
  span, the phase clocks summing to the request's wall, span names equal
  to JAX's engine's;
* ``/health`` (registry view and engine view) reporting the engine's swap
  counters, equal to JAX's server's.
"""

import json

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
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402
from test_torch_kv_offload import (  # noqa: E402,F401
    KW, SIDES, TIGHT, _cache, _clean, _prompts, models)
from test_torch_serving_slice import _get  # noqa: E402

FAULTS = {"jax": jfaults, "port": tfaults}
OBS = {"jax": jobs, "port": tobs}
SERVERS = {"jax": jsrv, "port": tsrv}
COUNTERS = ("preemptions", "resumes_swapped", "resumes_recompute",
            "prefill_tokens_avoided", "prefill_token_slots")
SWAP_CACHE = dict(TIGHT, host_pages=16)


def _engine(models, side, cache=None, knobs=None, **kw):
    se = SIDES[side][0]
    cfg, params = models[side]
    kw.setdefault("metrics_registry", False)
    eng = se.ContinuousBatchingEngine(
        cfg, params, cache if cache is not None
        else _cache(models, side, **SWAP_CACHE), **kw)
    for name, value in (knobs or {}).items():
        setattr(eng, name, value)
    return eng


def _by_rid(done):
    return {r.rid: (r.status, r.error, [int(t) for t in r.generated])
            for r in done}


def _same(j, t, extra=()):
    for name in COUNTERS + tuple(extra):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("swap_out_pages", "swap_in_pages", "swap_bytes"):
        assert getattr(t.cache, name) == getattr(j.cache, name), name


def _serve(eng, specs):
    rids = [eng.submit(p, max_new_tokens=n) for p, n in specs]
    done = {r.rid: [int(t) for t in r.generated]
            for r in eng.run_to_completion(max_steps=100_000)}
    return [done[r] for r in rids]


# -- the other lanes ---------------------------------------------------------
def test_horizon_swap_preemption_token_exact_as_jax(models):
    """Pool pressure mid-horizon swaps (swap priced to always win): the
    overlap + horizon-4 engine serves the horizon-1 engine's tokens, with
    JAX's swap and resume counts."""
    rng = np.random.RandomState(9)
    specs = [(rng.randint(1, 128, (L,)), 30) for L in (40, 44)]
    ck = dict(num_pages=9, pages_max=8, batch=2, page=16, host_pages=16)
    knobs = {"offload_swap_gbps": 1e9}
    res = {}
    for side in SIDES:
        eng = _engine(models, side, _cache(models, side, **ck), knobs,
                      decode_horizon=4, overlap=True)
        res[side] = (_serve(eng, specs), eng)
        _clean(eng.cache)
    (jt, je), (tt, te) = res["jax"], res["port"]
    assert tt == jt
    _same(je, te, ("horizon_trimmed_tokens",))
    assert te.preemptions > 0 and te.resumes_swapped > 0
    ref = _engine(models, "port", _cache(models, "port", **ck), knobs)
    assert _serve(ref, specs) == tt
    _clean(ref.cache)


def test_mixed_swap_preemption_exact_as_jax(models):
    """Pool pressure mid-mixed-service swaps the victims and their resumes
    restore through the carve (overlap lane, budget 16): tokens equal the
    sequential engine's and JAX's mixed engine's, counters JAX's."""
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, 128, (20,)), 60) for _ in range(3)]
    ck = dict(num_pages=11, pages_max=8, batch=3, page=16, host_pages=48)
    res = {}
    for side in SIDES:
        eng = _engine(models, side, _cache(models, side, **ck), mixed=True,
                      mixed_token_budget=16, overlap=True)
        res[side] = (_serve(eng, specs), eng)
        _clean(eng.cache)
    (jt, je), (tt, te) = res["jax"], res["port"]
    assert tt == jt
    _same(je, te, ("mixed_ticks", "mixed_prefill_tokens"))
    assert te.preemptions > 0 and te.resumes_swapped > 0
    ref = _engine(models, "port", _cache(models, "port", **ck))
    assert _serve(ref, specs) == tt


@pytest.fixture(scope="module")
def weak_draft():
    kw = dict(KW, num_hidden_layers=1, hidden_size=32)
    jcfg = jlp.LlamaPretrainConfig(**kw, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**kw, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(9), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return {"jax": (jcfg, jparams), "port": (tcfg, tparams)}


def test_spec_swap_preemption_token_exact_as_jax(models, weak_draft):
    """A target pool too small for both rows' growth preempts mid-spec and
    swaps: the resume restores the target row with zero prefill and
    re-prefills the draft row; tokens equal plain greedy decoding and
    JAX's spec engine, and both caches of both sides audit clean."""
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, 128, (16,)), 20) for _ in range(2)]
    res = {}
    for side in SIDES:
        se = SIDES[side][0]
        dcfg, dparams = weak_draft[side]
        dcache = _cache(weak_draft, side, num_pages=12, pages_max=5,
                        batch=2, page=16)
        spec = se.SpecConfig(gamma=3, source="draft", draft_cfg=dcfg,
                             draft_params=dparams, draft_cache=dcache)
        eng = _engine(models, side, _cache(
            models, side, num_pages=6, pages_max=5, batch=2, page=16,
            host_pages=32), spec=spec)
        rids = [eng.submit(p, max_new_tokens=n, spec=True)
                for p, n in specs]
        done = {r.rid: [int(t) for t in r.generated]
                for r in eng.run_to_completion()}
        res[side] = ([done[r] for r in rids], eng)
        _clean(eng.cache)
        _clean(dcache)
    (jt, je), (tt, te) = res["jax"], res["port"]
    assert tt == jt
    _same(je, te, ("spec_rounds", "spec_drafted", "spec_accepted"))
    assert te.preemptions > 0 and te.resumes_swapped > 0
    plain = _engine(models, "port", _cache(models, "port", num_pages=64,
                                           pages_max=8, batch=2, page=16))
    assert _serve(plain, specs) == tt


# -- containment -------------------------------------------------------------
def test_cancel_queued_swapped_request_discards_record_as_jax(models):
    """Cancelling a preempted request whose pages are parked in the host
    tier discards its record (host pages free, held refs release), as in
    JAX; the survivor serves."""
    res = {}
    for side in SIDES:
        eng = _engine(models, side)
        for p in _prompts(6):
            eng.submit(p, max_new_tokens=20)
        steps = 0
        while not eng._swap_handles:
            eng.step()
            steps += 1
            assert steps < 200, "no swap preemption happened"
        victim = next(iter(eng._swap_handles))
        assert eng.cancel(victim)
        res[side] = (victim, steps, _by_rid(eng.run_to_completion()))
        _clean(eng.cache)
    assert res["port"] == res["jax"]
    victim, _, out = res["port"]
    assert out[victim][0] == "cancelled"
    assert [v[0] for v in out.values()].count("ok") == 1


def test_step_fault_quarantine_overlap_offload_as_jax(models):
    """A step fault under the dispatch-ahead pipeline with the host tier
    attached: the wave quarantines, the host pool and the device pool come
    back clean, and a fresh request then serves, as in JAX."""
    res = {}
    for side in SIDES:
        eng = _engine(models, side, overlap=True)
        with FAULTS[side].plane() as fp:
            fp.inject("step_dispatch", RuntimeError("overlap fault"), nth=6)
            for p in _prompts(6):
                eng.submit(p, max_new_tokens=20)
            first = _by_rid(eng.run_to_completion())
        assert eng.step_faults >= 1
        assert not eng._inflight and eng._dev is None
        _clean(eng.cache)
        eng.submit(_prompts(77, n=1, L=10)[0], max_new_tokens=8)
        second = _by_rid(eng.run_to_completion())
        _clean(eng.cache)
        res[side] = (first, second, eng.step_faults, eng.resumes_swapped)
    assert res["port"] == res["jax"]
    assert [v[0] for v in res["port"][1].values()] == ["ok"]


@pytest.mark.parametrize("site", ["swap_in", "swap_out", "host_pool_full"])
def test_swap_faults_degrade_to_recompute_as_jax(models, site):
    """Each swap-path fault leaves preemption working recompute-style:
    tokens equal the engine without a host tier, no swapped resume, the
    same outcome as JAX's engine."""
    res = {}
    for side in SIDES:
        eng = _engine(models, side)
        with FAULTS[side].plane() as fp:
            fp.inject(site, None if site == "host_pool_full"
                      else RuntimeError(f"injected {site}"))
            toks = _serve(eng, [(p, 20) for p in _prompts(6)])
        _clean(eng.cache)
        res[side] = (toks, eng)
    (jt, je), (tt, te) = res["jax"], res["port"]
    assert tt == jt
    _same(je, te)
    assert te.preemptions > 0 and te.resumes_swapped == 0
    assert te.resumes_recompute > 0
    ref = _engine(models, "port", _cache(models, "port", **TIGHT))
    assert _serve(ref, [(p, 20) for p in _prompts(6)]) == tt


def test_swap_in_unexpected_exception_leaks_nothing_as_jax(models):
    """A non-``RuntimeError`` from the swap-in is a wave fault (no
    recompute contract), but the parked record is not stranded: the
    quarantine discards it, every request gets a finished record, the
    pools are clean, as in JAX."""
    res = {}
    for side in SIDES:
        eng = _engine(models, side)
        with FAULTS[side].plane() as fp:
            fp.inject("swap_in", ValueError("unexpected swap error"),
                      times=1)
            for p in _prompts(6):
                eng.submit(p, max_new_tokens=20)
            res[side] = _by_rid(eng.run_to_completion())
        _clean(eng.cache)
        assert len(eng._free_slots) == eng.B
    assert res["port"] == res["jax"]
    assert sorted(res["port"]) == [0, 1]
    assert any(st == "error" and "unexpected swap error" in err
               for st, err, _ in res["port"].values())


@pytest.mark.parametrize("swapped", [False, True],
                         ids=["roomy", "swapped_queued"])
def test_supervisor_transplant_over_host_tier_as_jax(models, swapped):
    """``EngineSupervisor`` over engines on caches with a host tier.
    ``roomy``: JAX's case (8 host pages, 64 device pages, a death at the
    4th dispatch).  ``swapped_queued``: the engine dies while a swapped
    request waits in its queue; the dead engine's record is discarded and
    the request resumes recompute-style on the rebuilt engine with the
    tokens of an unfaulted run.  Outcomes and counters equal JAX's, every
    cache clean."""
    prompts = _prompts(77, n=4, L=10) if not swapped else _prompts(6)
    new = 8 if not swapped else 20
    ck = (dict(num_pages=64, pages_max=8, batch=2, page=16, host_pages=8)
          if not swapped else SWAP_CACHE)
    res = {}
    for side in SIDES:
        reg = OBS[side].MetricsRegistry()
        caches = []

        def factory(side=side, reg=reg, caches=caches):
            cache = _cache(models, side, **ck)
            caches.append(cache)
            return _engine(models, side, cache, quarantine_faults=False,
                           metrics_registry=reg)

        sup = SIDES[side][0].EngineSupervisor(factory, max_restarts=3,
                                              backoff_s=0.0)
        with FAULTS[side].plane() as fp:
            for p in prompts:
                sup.submit(p, max_new_tokens=new)
            if swapped:
                while not sup.engine._swap_handles:
                    sup.step()
                # the next decode dispatch kills the engine
                fp.inject("step_dispatch", RuntimeError("engine death"),
                          nth=fp.counts.get("step_dispatch", 0) + 1)
            else:
                fp.inject("step_dispatch", RuntimeError("engine death"),
                          nth=4)
            done = _by_rid(sup.run_to_completion())
        for c in caches:
            _clean(c)
        res[side] = (done, sup.restarts, sup.engine.resumes_recompute,
                     sup.engine.resumes_swapped)
    assert res["port"] == res["jax"]
    done, restarts, recompute, _ = res["port"]
    assert restarts == 1
    assert [v[0] for v in done.values()].count("ok") >= 1
    if swapped:
        assert recompute >= 1
        ok = [r for r, v in done.items() if v[0] == "ok"]
        ref = _serve(_engine(models, "port"), [(p, 20) for p in prompts])
        for r in ok:
            assert done[r][2] == ref[r]


# -- tracing and /health -----------------------------------------------------
def test_swap_preemption_swapped_phase_and_span_as_jax(models):
    """With a host tier the victim parks ``swapped``: its trace holds the
    ``swapped`` phase and the ``swap_in`` restore span, its phase clocks
    sum to its wall, and every request's span names equal JAX's."""
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 128, (16,)) for _ in range(2)]
    names, victims = {}, {}
    for side in SIDES:
        obs = OBS[side]
        tr = obs.Tracer(obs.TraceStore(keep_slower_than_ms=0.0))
        eng = _engine(models, side, _cache(models, side, num_pages=6,
                                           pages_max=4, batch=2, page=16,
                                           host_pages=32),
                      {"offload_swap_gbps": 1e9}, tracer=tr)
        rids = [eng.submit(p, max_new_tokens=20) for p in prompts]
        done = {r.rid: r for r in eng.run_to_completion()}
        assert eng.resumes_swapped >= 1
        names[side] = {r: [s["name"] for s in tr.get(str(r))["spans"]]
                       for r in rids}
        victims[side] = next(r for r in done.values() if r.preempted)
        _clean(eng.cache)
    assert names["port"] == names["jax"]
    victim = victims["port"]
    spans = names["port"][victim.rid]
    assert "swapped" in spans and "swap_in" in spans
    clocks = tobs.phase_clocks(victim)
    assert clocks.get("swapped", 0) > 0
    assert abs(sum(clocks.values())
               - (victim.t_finish - victim.t_submit)) < 1e-6


@pytest.mark.parametrize("registry", [True, False],
                         ids=["registry_view", "engine_view"])
def test_health_reports_swap_counters_as_jax(models, registry):
    """``/health`` reports the engine's swap counters (the registry view,
    or the engine's attributes with ``metrics_registry=False``), equal to
    JAX's server's over the same run."""
    keys = ("swap_out_pages", "swap_in_pages", "prefill_tokens_avoided",
            "preemptions", "prefill_calls", "free_pages")
    docs = {}
    for side in SIDES:
        eng = _engine(models, side, metrics_registry=None if registry
                      else False)
        srv = SERVERS[side].GenerationServer(engine=eng)
        for p in _prompts(6):
            eng.submit(p, max_new_tokens=20)
        eng.run_to_completion()
        if side == "port":
            url = f"http://127.0.0.1:{srv.start()}"
            try:
                code, body, _ = _get(url + "/health")
            finally:
                srv.stop()
            assert code == 200
            h = json.loads(body)
        else:
            h = srv.health_snapshot()
        docs[side] = {k: h[k] for k in keys}
        assert docs[side]["swap_out_pages"] == eng.cache.swap_out_pages
        assert docs[side]["prefill_tokens_avoided"] == \
            eng.prefill_tokens_avoided
    assert docs["port"] == docs["jax"]
    assert docs["port"]["swap_in_pages"] > 0
    assert docs["port"]["prefill_tokens_avoided"] > 0
