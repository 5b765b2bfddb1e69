"""The port's speculative lane (``ContinuousBatchingEngine(spec=
SpecConfig(...))``, ``SpeculativeEngine``, ``generate_speculative``) held
against paddle_tpu's on the CPU, at the 2-layer fp32 config of
``tests/test_serving_spec.py`` (page 16, a 1-layer hidden-32 draft from
seed 9) with the same weights (``params_from_jax``) and the same
numpy-seeded prompts.

Every engine case runs JAX's engine on the same requests: tokens equal rid
for rid, and ``decode_steps``, ``host_syncs``, ``spec_rounds``,
``spec_drafted``, ``spec_accepted`` and ``gamma`` equal JAX's.  The
invariants of ``tests/test_serving_spec.py`` and
``tests/test_speculative.py``, in the port: token-exact against the plain
engine through slot churn (fp and int8 pages, a weak draft, sync and
overlap), the packed and ``packed=False`` admission lanes, chunked prefill
and prefix caching (prompt lookup), recompute preemption, a stop sequence
met inside a round (the trimmed tail counted as JAX counts it) and an eos
inside the accept window, one dispatch and one four-array ``_fetch`` a
round, the per-request mix and ``default_on``,
cancel and deadline, the rejections, adaptive gamma, the
``SpeculativeEngine`` shim, ``generate_speculative`` for an identical and a
weak draft, a ``step_dispatch`` fault on a round, the registry's spec
instruments and the HTTP front's ``/health`` and ``/metrics``.  Both caches
audit clean after every case.

The host-tier swap resume (``host_pages``) is held in
``tests/test_torch_serving_swap.py``, the spec pass-through of
disaggregation and of the fleet in ``tests/test_torch_disagg.py`` and
``tests/test_torch_fleet.py``.  JAX's TP (mesh) case waits for
ROADMAP.md queue 1 item 7.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these cases run tiny ops, and the default pool (one
# thread a core in each of the suite's xdist workers) oversubscribes the
# cores about tenfold
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu.observability as jobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu.models import speculative as jspec  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http)
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models import speculative as tspec  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402
from test_torch_serving_slice import _get  # noqa: E402

pytestmark = pytest.mark.spec

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
DRAFT_KW = dict(KW, num_hidden_layers=1, hidden_size=32)
COUNTERS = ("decode_steps", "host_syncs", "spec_rounds", "spec_drafted",
            "spec_accepted", "gamma")
SIDES = {"jax": (jse, jpd, jfaults), "port": (tse, tpd, tfaults)}


def _pair(kw, seed):
    jcfg = jlp.LlamaPretrainConfig(**kw, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**kw, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(seed), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return {"jax": (jcfg, jparams), "port": (tcfg, tparams)}


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(KW, 0), "weak": _pair(DRAFT_KW, 9)}


def _cache(models, side, which="target", num_pages=64, batch=2,
           kv_quant=None, pages_max=8):
    cfg = models[which][side][0]
    kw = dict(num_pages=num_pages, pages_max=pages_max, batch=batch,
              page=16, kv_quant=kv_quant)
    if side == "port":
        return tpd.PagedKVCache(cfg, device="cpu", **kw)
    return jpd.PagedKVCache(cfg, **kw)


def _engine(models, side, source="draft", draft="weak", gamma=3,
            kv_quant=None, num_pages=64, batch=2, pages_max=8, spec_kw=None,
            **kw):
    """A speculative engine of ``side`` -> (engine, cache, draft cache or
    None); ``draft="same"`` drafts with the target itself (every draft is
    accepted)."""
    se = SIDES[side][0]
    cfg, params = models["target"][side]
    cache = _cache(models, side, num_pages=num_pages, batch=batch,
                   kv_quant=kv_quant, pages_max=pages_max)
    dcache = None
    if source == "draft":
        which = "target" if draft == "same" else "weak"
        dcfg, dparams = models[which][side]
        dcache = _cache(models, side, which, num_pages=max(num_pages, 12),
                        batch=batch, kv_quant=kv_quant, pages_max=pages_max)
        spec = se.SpecConfig(gamma=gamma, source="draft", draft_cfg=dcfg,
                             draft_params=dparams, draft_cache=dcache,
                             **(spec_kw or {}))
    else:
        spec = se.SpecConfig(gamma=gamma, source="prompt_lookup",
                             **(spec_kw or {}))
    kw.setdefault("metrics_registry", False)
    return se.ContinuousBatchingEngine(cfg, params, cache, spec=spec,
                                       **kw), cache, dcache


def _serve(eng, specs, spec=True):
    """Submit ``specs`` ((prompt, new) pairs) and drive to the end ->
    tokens in submit order."""
    rids = [eng.submit(p, max_new_tokens=n, spec=spec) for p, n in specs]
    by = {r.rid: [int(t) for t in r.generated]
          for r in eng.run_to_completion()}
    return [by[r] for r in rids]


def _clean(cache):
    cache.audit()
    assert cache.free_pages() == cache.num_pages - 1


def _both(models, specs, spec=True, **kw):
    """Serve ``specs`` on the port's engine and on JAX's: tokens and
    counters equal, both sides' caches audit clean -> (tokens, port
    engine, its caches)."""
    out = {}
    for side in SIDES:
        eng, cache, dcache = _engine(models, side, **kw)
        out[side] = (_serve(eng, specs, spec), eng, cache, dcache)
    (jt, je, jc, jdc), (tt, te, tc, tdc) = out["jax"], out["port"]
    assert tt == jt
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    for c in (jc, jdc, tc, tdc):
        if c is not None and not kw.get("enable_prefix_caching"):
            _clean(c)
    assert not te._inflight
    return tt, te, tc, tdc


_PLAIN = {}


def _plain(models, specs, kv_quant=None, **kw):
    """The plain engine's tokens for ``specs``, served once per module for
    each set of arguments (several cases share one reference)."""
    key = (tuple((tuple(int(t) for t in p), n) for p, n in specs),
           kv_quant, tuple(sorted(kw.items())))
    if key not in _PLAIN:
        cfg, params = models["target"]["port"]
        cache = _cache(models, "port", kv_quant=kv_quant)
        eng = tse.ContinuousBatchingEngine(cfg, params, cache,
                                           metrics_registry=False, **kw)
        _PLAIN[key] = _serve(eng, specs, spec=None)
        _clean(cache)
    return [list(t) for t in _PLAIN[key]]


def _specs(seed, lens=None, n=5, new=None):
    rng = np.random.RandomState(seed)
    if lens is None:
        return [(rng.randint(1, 128, (int(rng.randint(3, 20)),)),
                 int(rng.randint(2, 9))) for _ in range(n)]
    return [(rng.randint(1, 128, (L,)), new) for L in lens]


# -- token-exact against the plain engine and JAX's spec engine ------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("overlap", [False, True])
def test_spec_churn_token_exact_as_jax(models, kv_quant, overlap):
    """tests/test_serving_spec.py's churn: five mixed-length requests
    through two slots, a weak draft, fp or int8 target and draft pages."""
    specs = _specs(0)
    ref = _plain(models, specs, kv_quant=kv_quant)
    got, eng, _, _ = _both(models, specs, kv_quant=kv_quant,
                           overlap=overlap)
    assert got == ref
    assert eng.spec_rounds > 0 and eng.spec_drafted > 0


@pytest.mark.parametrize("packed", [True, False])
def test_spec_admission_lanes_token_exact_as_jax(models, packed):
    specs = _specs(2, lens=(5, 18, 11), new=6)
    ref = _plain(models, specs, packed=packed)
    got, eng, _, _ = _both(models, specs, source="prompt_lookup", gamma=4,
                           packed=packed)
    assert got == ref and eng.spec_drafted > 0


def test_spec_chunked_prefill_and_prefix_cache_as_jax(models):
    specs = _specs(3, lens=(70,), new=7)
    ref = _plain(models, specs, prefill_chunk=32)
    got, _, _, _ = _both(models, specs, source="prompt_lookup",
                         prefill_chunk=32)
    assert got == ref
    # a shared 32-token stem, the second admission hits the cached prefix
    rng = np.random.RandomState(4)
    stem = rng.randint(1, 128, (32,))
    specs = [(np.concatenate([stem, rng.randint(1, 128, (k,))]), 6)
             for k in (3, 5)]
    ref = _plain(models, specs)
    outs = {}
    for side in SIDES:
        eng, cache, _ = _engine(models, side, source="prompt_lookup",
                                num_pages=96, enable_prefix_caching=True)
        toks = []
        for p, n in specs:               # one after the other
            toks += _serve(eng, [(p, n)])
        outs[side] = (toks, eng, cache)
    assert outs["port"][0] == outs["jax"][0] == ref
    for name in COUNTERS:
        assert getattr(outs["port"][1], name) == \
            getattr(outs["jax"][1], name), name
    assert outs["port"][2].prefix_hits == outs["jax"][2].prefix_hits >= 1
    outs["port"][2].audit()


def test_spec_recompute_preemption_as_jax(models):
    """A pool too small for both rows' growth preempts mid-spec; the
    resume re-prefills the draft too, and the draft cache's claims leave
    with the victim."""
    specs = _specs(5, lens=(16, 16), new=20)
    ref = _plain(models, specs)
    got, eng, _, _ = _both(models, specs, num_pages=6, pages_max=5)
    assert got == ref
    assert eng.preemptions > 0 and eng.resumes_recompute > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_spec_stop_sequences_and_eos_as_jax(models, overlap):
    """A stop sequence met inside a round retires where the plain lane
    does, the over-committed tail counted in ``horizon_trimmed_tokens``
    (as JAX counts it); an eos inside the accept window stops the row on
    the device.  The target drafts for itself, so rounds commit several
    tokens."""
    specs = _specs(13, lens=(9, 14, 6), new=16)
    free = _plain(models, specs)
    stop = free[0][5:7]                  # met mid-request
    eos = free[1][6]
    cfg, params = models["target"]["port"]
    outs = {}
    for side in SIDES:
        eng, cache, dcache = _engine(models, side, draft="same",
                                     overlap=overlap, eos_id=eos)
        rids = [eng.submit(p, max_new_tokens=n, spec=True,
                           stop_sequences=[stop] if i == 0 else None)
                for i, (p, n) in enumerate(specs)]
        by = {r.rid: list(r.generated) for r in eng.run_to_completion()}
        outs[side] = ([by[r] for r in rids], eng)
        _clean(cache)
        _clean(dcache)
    got, eng = outs["port"]
    assert got == outs["jax"][0]
    for name in COUNTERS + ("horizon_trimmed_tokens", "pipeline_flushes"):
        assert getattr(eng, name) == getattr(outs["jax"][1], name), name
    cache = _cache(models, "port")
    plain = tse.ContinuousBatchingEngine(cfg, params, cache, eos_id=eos,
                                         metrics_registry=False)
    rids = [plain.submit(p, max_new_tokens=n,
                         stop_sequences=[stop] if i == 0 else None)
            for i, (p, n) in enumerate(specs)]
    by = {r.rid: list(r.generated) for r in plain.run_to_completion()}
    assert got == [by[r] for r in rids]
    assert got[0][-2:] == stop and len(got[0]) < 16
    assert eng.horizon_trimmed_tokens > 0


# -- dispatch and fetch counts ---------------------------------------------
@pytest.mark.parametrize("overlap", [False, True])
def test_spec_one_dispatch_and_four_array_fetch_a_round(models, overlap):
    """draft == target accepts every draft: 8 decode tokens at gamma 3 are
    2 rounds, each one dispatch and one four-array ``_fetch`` (the overlap
    lane one chained round more, whose drafts never count)."""
    fetches = {}
    prompt = np.random.RandomState(1).randint(1, 128, (10,))
    for side in SIDES:
        eng, cache, _ = _engine(models, side, draft="same", batch=1,
                                overlap=overlap)
        orig = eng._fetch
        seen = fetches[side] = []
        eng._fetch = (lambda orig, seen: lambda *a: seen.append(len(a))
                      or orig(*a))(orig, seen)
        eng.submit(prompt, max_new_tokens=9, spec=True)
        (req,) = eng.run_to_completion()
        assert len(req.generated) == 9
        cache.audit()
        if side == "port":
            rounds = 3 if overlap else 2
            assert eng.decode_steps == eng.host_syncs == rounds
            assert eng.spec_rounds == 2
            assert eng.spec_drafted == eng.spec_accepted == 6
    # the port's _fetch also takes the event first
    assert fetches["port"] == [5] * len(fetches["jax"])
    assert fetches["jax"] == [4] * (3 if overlap else 2)


def test_spec_per_request_mix_and_default_on_as_jax(models):
    specs = _specs(11, lens=(9, 14), new=8)
    ref = _plain(models, specs)
    outs = {}
    for side in SIDES:
        eng, cache, dcache = _engine(models, side, draft="same",
                                     spec_kw={"default_on": False})
        r_on = eng.submit(specs[0][0], max_new_tokens=8, spec=True)
        r_off = eng.submit(specs[1][0], max_new_tokens=8)   # default: off
        done = {r.rid: list(r.generated) for r in eng.run_to_completion()}
        outs[side] = ([done[r_on], done[r_off]], eng)
        _clean(cache)
        _clean(dcache)
    got, eng = outs["port"]
    assert got == outs["jax"][0] == ref
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(outs["jax"][1], name), name
    # only the opted-in row drafted, and it accepted everything
    assert eng.spec_drafted == eng.spec_rounds * 3 == eng.spec_accepted


def test_spec_cancel_and_deadline_audit_clean_as_jax(models):
    res = {}
    for side in SIDES:
        eng, cache, dcache = _engine(models, side, overlap=True)
        now = [1000.0]
        eng._now = lambda: now[0]
        rng = np.random.RandomState(6)
        r1 = eng.submit(rng.randint(1, 128, (10,)), max_new_tokens=40,
                        spec=True)
        r2 = eng.submit(rng.randint(1, 128, (12,)), max_new_tokens=40,
                        deadline_s=5.0, spec=True)
        eng.step()
        eng.step()
        eng.cancel(r1)
        now[0] += 10.0
        by = {r.rid: r for r in eng.run_to_completion()}
        assert by[r1].status == "cancelled" and by[r2].status == "expired"
        _clean(cache)
        _clean(dcache)
        res[side] = {r: list(by[r].generated) for r in by}
    assert res["port"] == res["jax"]


def test_spec_rejections_name_the_constraint(models):
    cfg, params = models["target"]["port"]
    lookup = tse.SpecConfig(gamma=3, source="prompt_lookup")

    def mk(**kw):
        return tse.ContinuousBatchingEngine(
            cfg, params, _cache(models, "port"), **kw)

    with pytest.raises(ValueError, match="tune spec.gamma instead"):
        mk(spec=lookup, decode_horizon=4)
    with pytest.raises(ValueError, match="mixed"):
        mk(spec=lookup, mixed=True)
    with pytest.raises(ValueError, match="greedy-only"):
        mk(spec=lookup, temperature=0.7)
    with pytest.raises(ValueError, match="gamma"):
        mk(spec=tse.SpecConfig(gamma=0, source="prompt_lookup"))
    with pytest.raises(ValueError, match="source"):
        mk(spec=tse.SpecConfig(source="oracle"))
    with pytest.raises(ValueError, match="draft_cfg"):
        mk(spec=tse.SpecConfig(gamma=3, source="draft"))
    dcfg, dparams = models["weak"]["port"]
    with pytest.raises(ValueError, match="draft_cache batch"):
        mk(spec=tse.SpecConfig(
            draft_cfg=dcfg, draft_params=dparams,
            draft_cache=_cache(models, "port", "weak", batch=3)))
    with pytest.raises(ValueError, match="SpecConfig"):
        mk().submit(np.arange(1, 6), max_new_tokens=4, spec=True)
    # the scheduler policy and tenant quotas build beside spec; the TP
    # lanes still to port keep refusing
    qos = {"policy": tse.SchedulerPolicy(),
           "tenant_quotas": tse.TenantQuotas(rate_tokens_per_s=10.0)}
    assert mk(spec=lookup, **qos).quotas is qos["tenant_quotas"]
    for kw in ({"mesh": object()}, {"tp_allreduce": "int8"}):
        with pytest.raises(NotImplementedError):
            mk(spec=lookup, **qos, **kw)


@pytest.mark.parametrize("draft", ["same", "weak"])
def test_spec_adaptive_gamma_as_jax(models, draft):
    """An identical draft grows gamma toward max_gamma, a useless one
    shrinks it; tokens stay exact either way."""
    specs = _specs(8, lens=(8,), new=40)
    ref = _plain(models, specs)
    got, eng, _, _ = _both(models, specs, draft=draft, gamma=2, batch=1,
                           pages_max=12,
                           spec_kw={"adaptive_gamma": True, "max_gamma": 6})
    assert got == ref
    assert (eng.gamma > 2) if draft == "same" else (eng.gamma <= 2)


def test_speculative_engine_shim_serves_token_exact(models):
    """tests/test_speculative.py's batch through ``SpeculativeEngine``:
    a late admission mid-flight, streaming intact, both caches clean."""
    cfg, params = models["target"]["port"]
    dcfg, dparams = models["weak"]["port"]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 128, (int(rng.randint(4, 20)),))
               for _ in range(3)]
    news = [9, 9, 7]
    ref = _plain(models, list(zip(prompts, news)))
    cache = _cache(models, "port")
    dcache = _cache(models, "port", "weak")
    eng = tspec.SpeculativeEngine(cfg, params, cache, dcfg, dparams, dcache,
                                  gamma=3, metrics_registry=False)
    assert eng.dcfg is dcfg and eng.dparams is dparams
    assert eng.dcache is dcache
    for p, n in zip(prompts[:2], news[:2]):
        eng.submit(p, max_new_tokens=n)
    eng.step()                              # a late arrival mid-flight
    eng.submit(prompts[2], max_new_tokens=news[2])
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    assert [done[i] for i in range(3)] == ref
    streamed = {}
    for rid, t in eng.drain_stream():
        streamed.setdefault(rid, []).append(t)
    assert streamed == done
    assert eng.spec_rounds >= 1
    _clean(cache)
    _clean(dcache)


@pytest.mark.parametrize("draft", ["same", "weak"])
def test_generate_speculative_matches_greedy_and_jax(models, draft):
    """One sequence: the port's tokens equal the plain engine's greedy ones
    and JAX's ``generate_speculative``, with the same round statistics;
    an identical draft accepts all gamma drafts every round."""
    which = "target" if draft == "same" else "weak"
    prompt = np.random.RandomState(4).randint(1, 128, (10,))
    new, gamma = 13, 4
    cfg, params = models["target"]["port"]
    dcfg, dparams = models[which]["port"]
    got, stats = tspec.generate_speculative(cfg, params, dcfg, dparams,
                                            prompt, new, gamma=gamma,
                                            page=16, device="cpu")
    jcfg, jparams = models["target"]["jax"]
    jdcfg, jdparams = models[which]["jax"]
    want, jstats = jspec.generate_speculative(jcfg, jparams, jdcfg,
                                              jdparams, prompt, new,
                                              gamma=gamma, page=16)
    assert got.tolist() == want.tolist() == _plain(models, [(prompt,
                                                              new)])[0]
    assert stats == jstats
    if draft == "same":
        assert stats["mean_accepted"] == gamma
        assert stats["rounds"] == -(-(new - 1) // (gamma + 1))
    with pytest.raises(ValueError, match="gamma"):
        tspec.generate_speculative(cfg, params, cfg, params, prompt, 4,
                                   gamma=16, page=16, device="cpu")


# -- faults, metrics, the HTTP front ----------------------------------------
@pytest.mark.parametrize("overlap", [False, True])
def test_spec_round_fault_quarantines_its_wave_as_jax(models, overlap):
    """The second round raises at ``step_dispatch``: the first wave of two
    retires with the text, the queued two serve token-exact, and both
    caches audit clean."""
    specs = _specs(12, lens=(9, 13, 7, 11), new=10)
    ref = _plain(models, specs)
    res = {}
    for side in SIDES:
        eng, cache, dcache = _engine(models, side, overlap=overlap)
        with SIDES[side][2].plane() as fp:
            fp.inject("step_dispatch", RuntimeError("injected spec fault"),
                      nth=2)
            rids = [eng.submit(p, max_new_tokens=n, spec=True)
                    for p, n in specs]
            by = {r.rid: r for r in eng.run_to_completion()}
        res[side] = [(by[r].status, by[r].error, list(by[r].generated))
                     for r in rids]
        _clean(cache)
        _clean(dcache)
        if side == "port":
            assert eng.step_faults == 1 and eng.requests_faulted == 2
            assert not eng._inflight and eng._dev is None
    assert res["port"] == res["jax"]
    assert [s for s, _, _ in res["port"]] == ["error", "error", "ok", "ok"]
    assert res["port"][0][1] == "RuntimeError: injected spec fault"
    assert [g for _, _, g in res["port"][2:]] == ref[2:]


def test_spec_metrics_as_jax(models):
    """tests/test_observability.py's speculative instruments: the rounds,
    drafted and accepted counters, gamma, one accept-length observation a
    spec-on row a round, and the acceptance ratio, equal to JAX's."""
    vals = {}
    for side, obs in (("jax", jobs), ("port", tobs)):
        reg = obs.MetricsRegistry()
        eng, _, _ = _engine(models, side, draft="same",
                            metrics_registry=reg)
        eng.submit(np.random.RandomState(11).randint(1, 128, (9,)),
                   max_new_tokens=6)
        eng.run_to_completion()
        h = reg.get("paddle_tpu_engine_spec_accept_len_tokens")
        vals[side] = {name: reg.get(name).value for name in (
            "paddle_tpu_engine_spec_rounds_total",
            "paddle_tpu_engine_spec_drafted_tokens_total",
            "paddle_tpu_engine_spec_accepted_tokens_total",
            "paddle_tpu_engine_spec_gamma_tokens",
            "paddle_tpu_engine_spec_acceptance_ratio")}
        vals[side]["accept_len"] = (h.count, h.sum)
        if side == "port":
            assert eng.spec_rounds >= 1
            assert h.count == eng.spec_rounds and h.sum == eng.spec_accepted
            assert vals[side]["paddle_tpu_engine_spec_acceptance_ratio"] \
                == 1.0
    assert vals["port"] == vals["jax"]


@pytest.mark.parametrize("registry", [None, False])
def test_http_front_serves_the_spec_lane(models, registry):
    """``GenerationServer`` over a caller-built ``SpeculativeEngine``: the
    plain engine's tokens over HTTP, ``/health`` with JAX's spec fields
    (registry view or engine attributes) and ``/metrics`` with its spec
    metric names."""
    cfg, params = models["target"]["port"]
    rng = np.random.RandomState(33)
    prompts = [rng.randint(1, 128, (11,)), rng.randint(1, 128, (6,))]
    want = _plain(models, [(p, 6) for p in prompts])
    eng = tspec.SpeculativeEngine(cfg, params, _cache(models, "port"), cfg,
                                  params, _cache(models, "port"), gamma=3,
                                  metrics_registry=registry)
    srv = GenerationServer(engine=eng)
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        got = [generate_http(url, [int(t) for t in p], 6) for p in prompts]
        code, body, _ = _get(url + "/health")
        doc = json.loads(body)
        code_m, text, _ = _get(url + "/metrics")
    finally:
        srv.stop()
    assert got == want and code == 200 and code_m == 200
    assert eng.spec_rounds >= 1
    assert doc["spec_rounds"] == eng.spec_rounds
    assert doc["spec_drafted"] == eng.spec_drafted
    assert doc["spec_accepted"] == eng.spec_accepted == eng.spec_drafted
    assert doc["spec_acceptance"] == 1.0 and doc["gamma"] == 3
    if registry is None:
        text = text.decode()
        for name, v in (("paddle_tpu_engine_spec_rounds_total",
                         eng.spec_rounds),
                        ("paddle_tpu_engine_spec_drafted_tokens_total",
                         eng.spec_drafted),
                        ("paddle_tpu_engine_spec_gamma_tokens", 3)):
            assert f"{name} {v}" in text, name
        assert "paddle_tpu_engine_spec_accept_len_tokens_bucket" in text
    # a plain engine's /health has no spec fields, as JAX's
    plain = GenerationServer(cfg, params, _cache(models, "port"))
    assert "gamma" not in plain.health_snapshot()
    eng.cache.audit()
    eng.dcache.audit()
