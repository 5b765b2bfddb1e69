"""The port's disaggregated prefill / decode serving
(``paddle_tpu_torch/models/disagg.py``, the cache's hand-off records, the
router's prefill and decode roles) held against ``paddle_tpu``'s on the CPU,
at the 2-layer fp32 config of ``tests/test_disagg.py`` with the same weights
(``params_from_jax``) and the same numpy-seeded prompts.

Each case runs one scenario through JAX's coordinator (or router) and
through the port's, each side with its own engine, cache, fault plane,
observability and server modules (the same fault rules armed on both
planes), and holds the port to JAX's outcome: tokens, statuses, the streams,
``routed``, ``handoffs_shipped``, ``handoff_pages``, ``handoff_bytes``,
``colocated_fallbacks``, ``prefill_calls``, ``prefill_tokens_avoided`` and
``admission_stalls``; tokens also equal the port's unified engine's, and
``PagedKVCache.audit()`` is clean on every cache after every case.

The cases: one for each of ``tests/test_disagg.py``'s but its TP-mesh case
(ROADMAP.md queue 1 item 7); the three hand-off traces of
``tests/test_tracing.py``; the prefill engine's refusals of a decode horizon
(``tests/test_serving_horizon.py``) and of the mixed lane
(``tests/test_serving_mixed.py``); the speculative decode engine behind a
coordinator (``tests/test_serving_spec.py``); the two hand-off regressions
of ``tests/test_claim_regressions.py``; ``export_fetch``'s blocks against
JAX's bit for bit (fp32, bf16 and int8 pools, staged and synchronous); and
the coordinator behind ``GenerationServer``: ``/health``'s hand-off fields
and ``/metrics``' ``paddle_tpu_disagg_*`` series against JAX's front.
"""

import json
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these cases run tiny ops, and the default pool (one
# thread a core in each of the suite's xdist workers) oversubscribes the
# cores about tenfold
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu.fleet as jfleet  # noqa: E402
import paddle_tpu.inference.serving as jsrv  # noqa: E402
import paddle_tpu.models.disagg as jdg  # noqa: E402
import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu_torch.fleet as tfleet  # noqa: E402
import paddle_tpu_torch.inference.serving as tsrv  # noqa: E402
import paddle_tpu_torch.models.disagg as tdg  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
CACHE = dict(num_pages=64, pages_max=8, batch=2, page=16)
_RNG = np.random.RandomState(55)
PROMPTS = [_RNG.randint(1, 128, (L,)) for L in (10, 33, 21, 40)]
SHORT = [_RNG.randint(1, 128, (L,)) for L in (3, 5)]


@pytest.fixture(scope="module")
def sides():
    jcfg = jlp.LlamaPretrainConfig(**KW, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**KW, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(0), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return {
        "jax": types.SimpleNamespace(
            name="jax", se=jse, pd=jpd, dg=jdg, fleet=jfleet,
            faults=jfaults, obs=jobs, srv=jsrv, cfg=jcfg, params=jparams,
            dev={}),
        "port": types.SimpleNamespace(
            name="port", se=tse, pd=tpd, dg=tdg, fleet=tfleet,
            faults=tfaults, obs=tobs, srv=tsrv, cfg=tcfg, params=tparams,
            dev={"device": "cpu"})}


def both(sides, scenario):
    """``scenario(S)`` on each side -> (JAX's result, the port's)."""
    return scenario(sides["jax"]), scenario(sides["port"])


def cache(S, host_pages=32, **kw):
    ck = dict(CACHE)
    ck.update(kw)
    return S.pd.PagedKVCache(S.cfg, host_pages=host_pages, **ck, **S.dev)


def pair(S, pe_kw=None, de_kw=None, co_kw=None, pe_cache=None,
         de_cache=None):
    pe = S.dg.PrefillEngine(
        S.cfg, S.params, pe_cache if pe_cache is not None else cache(S),
        metrics_registry=False, **(pe_kw or {}))
    de = S.dg.DecodeEngine(
        S.cfg, S.params, de_cache if de_cache is not None else cache(S),
        metrics_registry=False, **(de_kw or {}))
    co = S.dg.DisaggCoordinator(pe, de, metrics_registry=False,
                                **dict({"force_route": "prefill"},
                                       **(co_kw or {})))
    return pe, de, co


_REF = {}


def unified(sides, prompts, new=8, kv_quant=None):
    """The port's unified engine's greedy tokens per prompt, once per
    module for each set of arguments."""
    key = (tuple(tuple(int(t) for t in p) for p in prompts), new, kv_quant)
    if key not in _REF:
        S = sides["port"]
        eng = S.se.ContinuousBatchingEngine(
            S.cfg, S.params, cache(S, host_pages=0, kv_quant=kv_quant),
            metrics_registry=False)
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done = {r.rid: list(r.generated) for r in eng.run_to_completion()}
        eng.cache.audit()
        _REF[key] = [done[r] for r in rids]
    return [list(t) for t in _REF[key]]


def drive(co, prompts, new=8, **submit_kw):
    """Submit and drive to the end -> (rids, rid -> Request, rid ->
    streamed tokens)."""
    rids = [co.submit(p, max_new_tokens=new, **submit_kw) for p in prompts]
    stream = {r: [] for r in rids}
    done = {}
    steps = 0
    while co.has_work():
        co.step()
        for rid, t in co.drain_stream():
            stream[rid].append(int(t))
        for r in co.finished():
            done[r.rid] = r
        steps += 1
        assert steps < 2000, "coordinator did not drain"
    return rids, done, stream


def tokens(done, rids):
    return [[int(t) for t in done[r].generated] for r in rids]


def counters(pe, de, co):
    return {"routed": dict(co.routed),
            "handoffs_shipped": co.handoffs_shipped,
            "handoff_pages": co.handoff_pages,
            "handoff_bytes": co.handoff_bytes,
            "colocated_fallbacks": co.colocated_fallbacks,
            "decode_colocated_fallbacks": de.colocated_fallbacks,
            "handoff_admits": de.handoff_admits,
            "prefill_prefill_calls": pe.prefill_calls,
            "decode_prefill_calls": de.prefill_calls,
            "prefill_tokens_avoided": de.prefill_tokens_avoided,
            "admission_stalls": pe.admission_stalls,
            "prefill_decode_steps": pe.decode_steps,
            "inflight": co._inflight_locked()}


def audit(*caches):
    for c in caches:
        c.audit()


# ---------------------------------------------------------------------------
# the cache's hand-off records against JAX's, bit for bit
# ---------------------------------------------------------------------------
def _fill(S, c, rng_seed, dt):
    """The same pseudo-random page contents on both sides: JAX's pools are
    [L, P, nkv, page, d] arrays, the port's the same shape in place."""
    rng = np.random.RandomState(rng_seed)
    shape = tuple(c.kpool.shape)
    if dt == "int8":
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.rand(*shape[:-1]).astype(np.float32) + 0.01
        vs = rng.rand(*shape[:-1]).astype(np.float32) + 0.01
    else:
        k = rng.randn(*shape).astype(np.float32).astype(dt)
        v = rng.randn(*shape).astype(np.float32).astype(dt)
        ks = vs = None
    if S.name == "jax":
        c.kpool, c.vpool = jnp.asarray(k), jnp.asarray(v)
        if ks is not None:
            c.kscale, c.vscale = jnp.asarray(ks), jnp.asarray(vs)
        return
    for name, a in (("kpool", k), ("vpool", v), ("kscale", ks),
                    ("vscale", vs)):
        if a is None:
            continue
        if a.dtype == ml_dtypes.bfloat16:
            t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        getattr(c, name).copy_(t)


def _bits(x, port):
    """A block's bits as an integer numpy array, JAX's [L, npg, ...]
    layout (the port's blocks are page-major)."""
    if x is None:
        return None
    if port:
        x = x.transpose(0, 1).contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        if x.dtype == torch.float32:
            return x.view(torch.int32).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


@pytest.mark.parametrize("pool,host_pages", [
    ("f32", 32), ("bf16", 32), ("int8", 32), ("f32", 2)],
    ids=["f32-staged", "bf16-staged", "int8-staged", "f32-sync"])
def test_export_fetch_blocks_equal_jax_bit_for_bit(sides, pool, host_pages):
    """Rows of 21 and 40 tokens over the same page contents: export,
    fetch, discard and adopt equal JAX's call for call, the blocks bit for
    bit (scale planes included), through the staged host tier and through
    the synchronous gather a short host tier falls back to."""
    def run(S):
        kw = dict(host_pages=host_pages)
        if pool == "int8":
            kw["kv_quant"] = "int8"
        elif pool == "bf16":
            kw["dtype"] = jnp.bfloat16 if S.name == "jax" \
                else torch.bfloat16
        src, dst = cache(S, **kw), cache(S, **dict(kw, host_pages=32))
        dt = {"f32": np.float32, "bf16": ml_dtypes.bfloat16,
              "int8": "int8"}[pool]
        for b, L in enumerate((21, 40)):
            src.alloc_row(b, L)
        src.lens[:] = [21, 40]
        _fill(S, src, 3, dt)
        states = [src.export_row(b) for b in (1, 0)]
        staged = ["hids" in st for st in states]
        held = src.audit()
        blobs = [src.export_fetch(st) for st in states]
        src.export_discard(states[0])           # fetched: a no-op
        handles = [dst.adopt_swap(*bl) for bl in blobs]
        port = S.name == "port"
        bits = [[_bits(x, port) for x in bl[:4]] + [int(bl[4])]
                for bl in blobs]
        # an unfetched export discards its staging pages
        src.alloc_row(0, 30)
        src.lens[0] = 30
        late = src.export_row(0)
        src.export_discard(late)
        return (bits, staged, held, src.audit(), dst.audit(),
                [dst.swap_ctx_len(h) for h in handles],
                [dst.swap_pages_needed(h) for h in handles])

    j, t = both(sides, run)
    for (jb, tb) in zip(j[0], t[0]):
        assert jb[4] == tb[4]
        for a, b in zip(jb[:4], tb[:4]):
            if a is None:
                assert b is None
            else:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert t[1:] == j[1:]
    # two host pages: the 40-token row (3 pages) falls back to the
    # synchronous gather, the 21-token row (2 pages) still stages
    assert t[1] == ([True, True] if host_pages == 32 else [False, True])


def test_adopt_swap_refuses_before_changing_anything(sides):
    """No host tier or too little room (``RuntimeError``), a dtype or
    ``kv_quant`` mismatch (``ValueError``): nothing changes, as JAX's."""
    def run(S):
        src = cache(S)
        src.alloc_row(0, 40)
        src.lens[0] = 40
        blob = src.export_fetch(src.export_row(0))
        out = []
        for dst, exc in ((cache(S, host_pages=0), RuntimeError),
                         (cache(S, host_pages=2), RuntimeError),
                         (cache(S, kv_quant="int8"), ValueError)):
            before = dst.audit()
            with pytest.raises(exc) as e:
                dst.adopt_swap(*blob)
            assert dst.audit() == before
            out.append(type(e.value).__name__)
        q8 = cache(S, kv_quant="int8")
        q8.alloc_row(0, 40)
        q8.lens[0] = 40
        k, v, ks, vs, L = q8.export_fetch(q8.export_row(0))
        with pytest.raises(ValueError, match="kv_quant mismatch"):
            cache(S, kv_quant="int8").adopt_swap(k, v, None, None, L)
        audit(src, q8)
        return out

    j, t = both(sides, run)
    assert t == j


# ---------------------------------------------------------------------------
# token-exactness and the zero-prefill pin (tests/test_disagg.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["packed", "chunked", "int8", "overlap"])
def test_disagg_token_exact_and_zero_prefill_on_decode(sides, lane):
    """1P+1D tokens equal JAX's coordinator's and the unified engine's on
    the packed and chunked admission lanes, over int8 pages (pages and
    scale planes shipped bitwise) and with an ``overlap=True`` decode
    engine; the decode engine never prefills, every context token rides
    the hand-off, and the stream carries each token once."""
    def run(S):
        kw = {}
        if lane == "chunked":
            kw["pe_kw"] = dict(packed=False, prefill_chunk=32)
        elif lane == "int8":
            kw["pe_cache"] = cache(S, kv_quant="int8")
            kw["de_cache"] = cache(S, kv_quant="int8")
        elif lane == "overlap":
            kw["de_kw"] = dict(overlap=True)
        pe, de, co = pair(S, **kw)
        rids, done, stream = drive(co, PROMPTS)
        assert all(done[r].status == "ok" for r in rids)
        for r in rids:
            assert stream[r] == [int(t) for t in done[r].generated]
        audit(pe.cache, de.cache)
        return tokens(done, rids), counters(pe, de, co), de.decode_steps

    j, t = both(sides, run)
    assert t == j
    toks, c, _ = t
    assert toks == unified(sides, PROMPTS,
                           kv_quant="int8" if lane == "int8" else None)
    assert c["decode_prefill_calls"] == 0
    assert c["prefill_decode_steps"] == 0 and c["prefill_prefill_calls"] >= 1
    assert c["handoffs_shipped"] == c["handoff_admits"] == len(PROMPTS)
    assert c["routed"] == {"prefill": len(PROMPTS), "colocated": 0}
    assert c["prefill_tokens_avoided"] == sum(len(p) for p in PROMPTS)
    assert c["inflight"] == 0


def test_first_token_at_max_new_tokens_1_finishes_on_prefill(sides):
    def run(S):
        pe, de, co = pair(S)
        rids, done, stream = drive(co, PROMPTS[:2], new=1)
        for r in rids:
            assert stream[r] == [int(t) for t in done[r].generated]
        audit(pe.cache, de.cache)
        return tokens(done, rids), counters(pe, de, co)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == unified(sides, PROMPTS[:2], new=1)
    assert t[1]["handoffs_shipped"] == t[1]["handoff_admits"] == 0


# ---------------------------------------------------------------------------
# the cost model, and the prefill lane's fallback
# ---------------------------------------------------------------------------
def test_cost_model_keeps_short_prompts_colocated(sides):
    prompts = PROMPTS + SHORT

    def run(S):
        pe, de, co = pair(S, co_kw=dict(force_route=None))
        lo = min(S.dg.handoff_flip_gbps(len(p), de) for p in PROMPTS)
        hi = min(S.dg.handoff_flip_gbps(len(p), de) for p in SHORT)
        assert lo < hi, "page rounding must separate the thresholds"
        co.handoff_gbps = float(np.sqrt(lo * hi))
        assert S.dg.handoff_wins(max(len(p) for p in PROMPTS), de,
                                 co.handoff_gbps)
        assert not S.dg.handoff_wins(min(len(p) for p in SHORT), de,
                                     co.handoff_gbps)
        rids, done, _ = drive(co, prompts)
        audit(pe.cache, de.cache)
        return (tokens(done, rids), counters(pe, de, co),
                [S.dg.handoff_flip_gbps(len(p), de) for p in prompts])

    j, t = both(sides, run)
    assert t[:2] == j[:2]
    np.testing.assert_allclose(t[2], j[2], rtol=1e-12)
    assert t[0] == unified(sides, prompts)
    c = t[1]
    assert c["routed"] == {"prefill": len(PROMPTS), "colocated": len(SHORT)}
    assert c["decode_prefill_calls"] > 0
    assert c["handoff_admits"] == len(PROMPTS)


def test_prefill_queue_full_falls_back_colocated(sides):
    def run(S):
        pe, de, co = pair(S, pe_kw=dict(max_queue_len=2))
        rids = [co.submit(p, max_new_tokens=8) for p in PROMPTS[:3]]
        routed = dict(co.routed)
        ready = co.queue_capacity_reason(len(PROMPTS[0]))
        done = {}
        steps = 0
        while co.has_work():
            co.step()
            for r in co.finished():
                done[r.rid] = r
            steps += 1
            assert steps < 2000
        audit(pe.cache, de.cache)
        return tokens(done, rids), routed, ready, counters(pe, de, co)

    j, t = both(sides, run)
    assert t == j
    assert t[1] == {"prefill": 2, "colocated": 1} and t[2] is None
    assert t[0] == unified(sides, PROMPTS[:3])


# ---------------------------------------------------------------------------
# faults: the kv_handoff halves, a full receiving tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("half,nth", [("ship", 1), ("restore", 2)])
def test_handoff_fault_degrades_to_colocated(sides, half, nth):
    def run(S):
        pe, de, co = pair(S)
        with S.faults.plane() as fp:
            fp.inject("kv_handoff", RuntimeError(f"{half} fault"), nth=nth,
                      times=1)
            rids, done, stream = drive(co, PROMPTS)
            fired = fp.fired.get("kv_handoff", 0)
        for r in rids:
            assert stream[r] == [int(t) for t in done[r].generated]
        audit(pe.cache, de.cache)
        return tokens(done, rids), counters(pe, de, co), fired

    j, t = both(sides, run)
    assert t == j
    assert t[0] == unified(sides, PROMPTS)
    c = t[1]
    assert c["colocated_fallbacks"] == c["decode_colocated_fallbacks"] == 1
    assert c["decode_prefill_calls"] >= 1 and t[2] == 1
    assert c["inflight"] == 0


def test_receiving_host_tier_full_falls_back(sides):
    def run(S):
        pe, de, co = pair(S, de_cache=cache(S, host_pages=1))
        rids, done, _ = drive(co, PROMPTS)
        audit(pe.cache, de.cache)
        return tokens(done, rids), counters(pe, de, co)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == unified(sides, PROMPTS)
    assert t[1]["colocated_fallbacks"] >= sum(len(p) > 16 for p in PROMPTS)


# ---------------------------------------------------------------------------
# the bounded pipeline; cancel and deadline mid-hand-off
# ---------------------------------------------------------------------------
def test_bounded_inflight_backpressures_admission(sides):
    def run(S):
        pe, de, co = pair(S, pe_kw=dict(max_inflight_handoffs=1))
        rids = [co.submit(p, max_new_tokens=8) for p in PROMPTS]
        done = {}
        peak = steps = 0
        while co.has_work():
            co.step()
            peak = max(peak, co._inflight_locked())
            for r in co.finished():
                done[r.rid] = r
            steps += 1
            assert steps < 2000
        audit(pe.cache, de.cache)
        return tokens(done, rids), peak, counters(pe, de, co)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == unified(sides, PROMPTS)
    assert t[1] <= 1 and t[2]["admission_stalls"] > 0


def test_cancel_and_deadline_mid_handoff_reclaim_records(sides):
    def run(S):
        pe, de, co = pair(S)
        t0 = 1000.0
        co._now = lambda: t0
        r_cancel = co.submit(PROMPTS[0], max_new_tokens=8)
        r_expire = co.submit(PROMPTS[1], max_new_tokens=8, deadline_s=50.0)
        co.step()
        where = {co._requests[r_cancel].where,
                 co._requests[r_expire].where}
        held = pe.cache.host.used_pages()
        assert co.cancel(r_cancel) is True
        co._now = lambda: t0 + 100.0
        co.step()
        done = {r.rid: r.status for r in co.finished()}
        out = (where, held, done, pe.cache.host.used_pages(),
               counters(pe, de, co), co.has_work())
        audit(pe.cache, de.cache)
        return out

    j, t = both(sides, run)
    assert t == j
    where, held, done, used, c, work = t
    assert where == {"handoff"} and held > 0 and used == 0
    assert sorted(done.values()) == ["cancelled", "expired"]
    assert c["handoff_admits"] == c["decode_prefill_calls"] == 0
    assert c["inflight"] == 0 and not work


def test_supervisor_restart_reregisters_inflight_handoff(sides):
    """A DecodeEngine rebuilt by its EngineSupervisor re-adopts the
    hand-off it held for the transplanted queue: the request completes
    through the zero-prefill restore, token-exact."""
    busy_p, long_p = SHORT[0], PROMPTS[1]

    def run(S):
        def de_factory():
            return S.dg.DecodeEngine(
                S.cfg, S.params, cache(S, batch=1), metrics_registry=False,
                quarantine_faults=False)

        pe = S.dg.PrefillEngine(S.cfg, S.params, cache(S),
                                metrics_registry=False)
        sup = S.se.EngineSupervisor(de_factory, max_restarts=3,
                                    backoff_s=0.0)
        de = sup.engine
        busy = de.submit(busy_p, max_new_tokens=20)
        sup.step()
        pe.submit(long_p, max_new_tokens=8)
        pe.step()
        rec = pe.take_handoffs()[0]
        local = de.admit_handoff(rec)
        assert de.pending_handoffs() == 1
        with S.faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("boom"), every=1,
                      times=1)
            sup.step()
        new = sup.engine
        state = (sup.restarts, new is not de, len(new._queue),
                 local in new._swap_handles, new.pending_handoffs())
        done = {r.rid: r for r in sup.finished()}
        done.update({r.rid: r for r in sup.run_to_completion()})
        audit(new.cache, pe.cache)
        return (state, done[busy].status, done[local].status,
                [int(x) for x in done[local].generated], new.prefill_calls)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == (1, True, 1, True, 1)
    assert t[1:3] == ("error", "ok")
    assert t[3] == unified(sides, [long_p])[0] and t[4] == 0


# ---------------------------------------------------------------------------
# construction contracts (tests/test_disagg.py, test_serving_horizon.py,
# test_serving_mixed.py)
# ---------------------------------------------------------------------------
def test_validation_errors(sides):
    for S in sides.values():
        cfg, params = S.cfg, S.params
        with pytest.raises(ValueError, match="no decode loop"):
            S.dg.PrefillEngine(cfg, params, cache(S),
                               metrics_registry=False, overlap=True)
        with pytest.raises(ValueError, match="host page tier"):
            S.dg.DecodeEngine(cfg, params, cache(S, host_pages=0),
                              metrics_registry=False)
        plain = S.se.ContinuousBatchingEngine(cfg, params, cache(S),
                                              metrics_registry=False)
        de = S.dg.DecodeEngine(cfg, params, cache(S),
                               metrics_registry=False)
        with pytest.raises(ValueError, match="PrefillEngine"):
            S.dg.DisaggCoordinator(plain, de, metrics_registry=False)
        pe = S.dg.PrefillEngine(cfg, params, cache(S),
                                metrics_registry=False)
        with pytest.raises(ValueError, match="DecodeEngine"):
            S.dg.DisaggCoordinator(pe, plain, metrics_registry=False)
        with pytest.raises(ValueError, match="force_route"):
            S.dg.DisaggCoordinator(pe, de, force_route="sideways",
                                   metrics_registry=False)
        with pytest.raises(ValueError, match="roles"):
            S.fleet.FleetRouter([lambda: plain], roles=["prefill", "decode"],
                                metrics_registry=False)
        with pytest.raises(ValueError, match="role='prefill'"):
            S.fleet.FleetRouter([lambda: S.se.ContinuousBatchingEngine(
                cfg, params, cache(S), metrics_registry=False)],
                roles=["prefill"], metrics_registry=False)
        with pytest.raises(ValueError, match="unknown replica role"):
            S.fleet.FleetRouter([lambda: plain], roles=["sideways"],
                                metrics_registry=False)


def test_prefill_engine_refuses_a_decode_horizon(sides):
    for S in sides.values():
        c = S.pd.PagedKVCache(S.cfg, num_pages=32, pages_max=8, batch=2,
                              page=16, host_pages=8, **S.dev)
        with pytest.raises(ValueError, match="no decode cadence"):
            S.dg.PrefillEngine(S.cfg, S.params, c, decode_horizon=4)


def test_mixed_refused_on_the_disaggregated_engines(sides):
    """PrefillEngine and DecodeEngine refuse ``mixed=True`` naming the
    constraint, and a mixed colocated lane keeps every request colocated
    (its flip reads ``inf``)."""
    for S in sides.values():
        def mk(host):
            return S.pd.PagedKVCache(S.cfg, num_pages=32, pages_max=8,
                                     batch=2, page=16, host_pages=host,
                                     **S.dev)
        with pytest.raises(ValueError, match="mixed"):
            S.dg.PrefillEngine(S.cfg, S.params, mk(16), mixed=True)
        with pytest.raises(ValueError, match="mixed"):
            S.dg.DecodeEngine(S.cfg, S.params, mk(16), mixed=True)
        mixed = S.se.ContinuousBatchingEngine(
            S.cfg, S.params, mk(0), metrics_registry=False, mixed=True,
            mixed_token_budget=16)
        assert S.dg.handoff_flip_gbps(64, mixed) == float("inf")
        assert not S.dg.handoff_wins(64, mixed, gbps=1e9)
        de = S.dg.DecodeEngine(S.cfg, S.params, mk(16),
                               metrics_registry=False)
        assert S.dg.handoff_flip_gbps(0, de) == float("inf")


def test_mismatched_decode_geometry_rejected_upfront(sides):
    def run(S):
        pe, de, co = pair(S, de_cache=cache(S, pages_max=2))
        with pytest.raises(ValueError, match="row capacity"):
            co.submit(PROMPTS[3], max_new_tokens=30)
        with pytest.raises(ValueError, match="geometries disagree"):
            de._import_request(S.se.Request(0, PROMPTS[3], 30,
                                            generated=[1]))
        audit(pe.cache, de.cache)
        return co.has_work(), counters(pe, de, co)

    j, t = both(sides, run)
    assert t == j and t[0] is False


# ---------------------------------------------------------------------------
# the fleet tier: role lanes, failover, reclamation
# ---------------------------------------------------------------------------
def role_factories(S):
    def pf():
        return S.dg.PrefillEngine(S.cfg, S.params, cache(S),
                                  metrics_registry=False)

    def df():
        return S.dg.DecodeEngine(S.cfg, S.params, cache(S),
                                 metrics_registry=False)
    return pf, df


def fleet_counters(router):
    return {"routed": dict(router.routed),
            "disagg_decisions": dict(router.disagg_decisions),
            "handoffs_shipped": router.handoffs_shipped,
            "handoff_pages": router.handoff_pages,
            "handoff_bytes": router.handoff_bytes,
            "colocated_fallbacks": router.colocated_fallbacks,
            "failovers": router.failovers, "deaths": router.deaths,
            "replaces": router.replaces,
            "route_errors": router.route_errors,
            "prefill_calls": [h.engine.prefill_calls
                              for h in router._replicas],
            "states": [h.state for h in router._replicas],
            "inflight": router._inflight_handoffs_locked()}


def outcome(done, rids):
    return [(done[r].status, [int(t) for t in done[r].generated])
            for r in rids]


def test_fleet_roles_token_exact_zero_prefill_on_decode(sides):
    def run(S):
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df, df],
                                     roles=["prefill", "decode", "decode"],
                                     metrics_registry=False,
                                     handoff_gbps=1e9)
        rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
        done = {r.rid: r for r in router.run_to_completion()}
        audit(*(h.engine.cache for h in router._replicas))
        snap = router.fleet_snapshot()
        return (outcome(done, rids), fleet_counters(router), snap["roles"],
                snap["disagg"], [r["role"] for r in snap["replicas"]])

    j, t = both(sides, run)
    assert t == j
    assert [g for _, g in t[0]] == unified(sides, PROMPTS)
    c = t[1]
    assert c["routed"]["disagg"] == c["handoffs_shipped"] == len(PROMPTS)
    assert c["prefill_calls"][1:] == [0, 0]
    assert t[2] == {"unified": 0, "prefill": 1, "decode": 2}
    assert t[3]["handoffs_inflight"] == 0
    assert t[4] == ["prefill", "decode", "decode"]


def test_fleet_cost_model_splits_lanes(sides):
    prompts = PROMPTS + SHORT

    def run(S):
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df], roles=["prefill", "decode"],
                                     metrics_registry=False)
        de = router._replicas[1].engine
        router.handoff_gbps = float(np.sqrt(
            min(S.dg.handoff_flip_gbps(len(p), de) for p in PROMPTS)
            * min(S.dg.handoff_flip_gbps(len(p), de) for p in SHORT)))
        rids = [router.submit(p, max_new_tokens=8) for p in prompts]
        done = {r.rid: r for r in router.run_to_completion()}
        audit(*(h.engine.cache for h in router._replicas))
        return outcome(done, rids), fleet_counters(router)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, g in t[0]] == unified(sides, prompts)
    assert t[1]["disagg_decisions"] == {"disagg": len(PROMPTS),
                                        "colocated": len(SHORT)}


def test_fleet_prefill_death_reclaims_records_and_fails_over(sides):
    """A prefill replica dying with exported, untaken records: their
    staging pages come back and the requests (nothing streamed) fail over
    to the serve lane as colocated re-prefills, token-exact."""
    def run(S):
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df], roles=["prefill", "decode"],
                                     metrics_registry=False,
                                     handoff_gbps=1e9)
        rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
        pe = router._replicas[0].engine
        pe.step()
        ready, held = len(pe._handoff_ready), pe.cache.host.used_pages()
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("prefill died"), nth=1,
                      times=1)
            done = {r.rid: r for r in router.run_to_completion()}
        used = pe.cache.host.used_pages()
        audit(pe.cache, *(h.engine.cache for h in router._replicas))
        return (outcome(done, rids), ready, held > 0, used,
                fleet_counters(router))

    j, t = both(sides, run)
    assert t == j
    assert t[0] == [("ok", g) for g in unified(sides, PROMPTS[:2])]
    assert t[1] == 2 and t[2] and t[3] == 0
    assert t[4]["failovers"] == 2


def test_fleet_decode_death_mid_handoff_fails_over(sides):
    def run(S):
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df, df],
                                     roles=["prefill", "decode", "decode"],
                                     metrics_registry=False,
                                     handoff_gbps=1e9)
        rid = router.submit(PROMPTS[0], max_new_tokens=8)
        router.step()
        pending = len(router._handoffs)
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("decode died"), nth=1,
                      times=1)
            done = {r.rid: r for r in router.run_to_completion()}
        audit(*(h.engine.cache for h in router._replicas))
        return outcome(done, [rid]), pending, fleet_counters(router)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == [("ok", unified(sides, PROMPTS[:1])[0])]
    assert t[1] == 1
    assert t[2]["deaths"] == 1 and t[2]["failovers"] == 1


def test_fleet_handoff_fault_degrades_colocated(sides):
    def run(S):
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df], roles=["prefill", "decode"],
                                     metrics_registry=False,
                                     handoff_gbps=1e9)
        with S.faults.plane() as fp:
            fp.inject("kv_handoff", RuntimeError("wire down"), nth=1,
                      times=1)
            rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
            done = {r.rid: r for r in router.run_to_completion()}
        audit(*(h.engine.cache for h in router._replicas))
        return (outcome(done, rids), fleet_counters(router),
                router._replicas[1].engine.colocated_fallbacks)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, g in t[0]] == unified(sides, PROMPTS[:2])
    assert t[1]["colocated_fallbacks"] == 1 and t[2] == 1
    assert t[1]["routed"]["failover"] == 0


def test_fleet_route_fault_on_prefill_lane_falls_back(sides):
    def run(S):
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df], roles=["prefill", "decode"],
                                     metrics_registry=False,
                                     handoff_gbps=1e9)
        with S.faults.plane() as fp:
            fp.inject("route_dispatch", RuntimeError("handoff refused"),
                      nth=1, times=1)
            rid = router.submit(PROMPTS[0], max_new_tokens=8)
            done = {r.rid: r for r in router.run_to_completion()}
        audit(*(h.engine.cache for h in router._replicas))
        return outcome(done, [rid]), fleet_counters(router)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == [("ok", unified(sides, PROMPTS[:1])[0])]
    assert t[1]["route_errors"] == 1 and t[1]["routed"]["disagg"] == 0
    assert t[1]["disagg_decisions"]["colocated"] == 1


# ---------------------------------------------------------------------------
# observability: the metrics, the traces, the HTTP front
# ---------------------------------------------------------------------------
DISAGG_SERIES = ("paddle_tpu_disagg_handoff_pages_total",
                 "paddle_tpu_disagg_handoff_bytes_total",
                 "paddle_tpu_disagg_handoff_inflight_count",
                 "paddle_tpu_disagg_routed_prefill_total",
                 "paddle_tpu_disagg_routed_colocated_total",
                 "paddle_tpu_disagg_colocated_fallback_total")


def test_disagg_metrics_registered_and_settle(sides):
    def run(S):
        reg = S.obs.MetricsRegistry()
        pe = S.dg.PrefillEngine(S.cfg, S.params, cache(S),
                                metrics_registry=reg)
        de = S.dg.DecodeEngine(S.cfg, S.params, cache(S),
                               metrics_registry=reg)
        co = S.dg.DisaggCoordinator(pe, de, force_route="prefill")
        assert co.metrics is not None and co.metrics.registry is reg
        drive(co, PROMPTS[:2])
        snap = reg.snapshot()
        hist = snap["paddle_tpu_disagg_handoff_seconds"]
        return ({n: snap[n]["value"] for n in DISAGG_SERIES},
                hist["count"], de.cache.page_bytes)

    j, t = both(sides, run)
    assert t == j
    pages = sum(-(-len(p) // 16) for p in PROMPTS[:2])
    vals, count, page_bytes = t
    assert vals["paddle_tpu_disagg_handoff_pages_total"] == pages
    assert vals["paddle_tpu_disagg_handoff_bytes_total"] == \
        pages * page_bytes
    assert count == 2
    assert vals["paddle_tpu_disagg_handoff_inflight_count"] == 0
    assert vals["paddle_tpu_disagg_routed_prefill_total"] == 2


def keep_all(S):
    return S.obs.Tracer(S.obs.TraceStore(keep_slower_than_ms=0.0))


def test_disagg_handoff_one_stitched_trace(sides):
    """One trace under the coordinator rid spans both engines: the prefill
    side's queued and prefill phases, handoff_inflight, the decode side,
    the export event and the ship span; the phase clocks sum to the
    request's wall."""
    must = ("handoff_export", "handoff_ship", "queued", "prefill",
            "handoff_inflight", "decode_active")

    def run(S):
        tr = keep_all(S)
        pe, de, co = pair(S, co_kw=dict(tracer=tr))
        rids, done, _ = drive(co, PROMPTS[:2], new=6)
        out = []
        for rid in rids:
            req = done[rid]
            clocks = S.obs.phase_clocks(req)
            assert clocks.get("handoff_inflight", 0) > 0
            assert abs(sum(clocks.values())
                       - (req.t_finish - req.t_submit)) < 1e-6
            doc = tr.get(str(rid))
            names = [s["name"] for s in doc["spans"]]
            for name in must:
                assert name in names, (S.name, name, names)
            engines = {s["attrs"].get("engine")
                       for s in doc["spans"] if "engine" in s["attrs"]}
            assert {"prefill", "decode"} <= engines
            assert doc["attrs"]["clocks"]["handoff_inflight"] > 0
            out.append((req.status, doc["status"], sorted(set(names))))
        assert tr.index(status="live") == []
        audit(pe.cache, de.cache)
        return out

    j, t = both(sides, run)
    assert t == j


def test_fleet_failover_plus_handoff_single_trace(sides):
    """A disagg-lane request whose decode replica dies in the adopted, not
    yet admitted window: one trace at the fleet rid with both replicas,
    the ship, the failover gap and phase spans covering the wall."""
    def run(S):
        tr = keep_all(S)
        pf, df = role_factories(S)
        router = S.fleet.FleetRouter([pf, df, df],
                                     roles=["prefill", "decode", "decode"],
                                     metrics_registry=False,
                                     handoff_gbps=1e9, tracer=tr)
        rid = router.submit(PROMPTS[0], max_new_tokens=6)
        router.step()
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("decode died"), nth=1,
                      times=1)
            done = {r.rid: r for r in router.run_to_completion()}
        doc = tr.get(str(rid))
        names = [s["name"] for s in doc["spans"]]
        replicas = {s["attrs"].get("replica") for s in doc["spans"]
                    if "replica" in s["attrs"]}
        covered = sum(s["dur_s"] for s in doc["spans"]
                      if s["name"] in S.obs.PHASES)
        assert covered == pytest.approx(doc["spans"][0]["dur_s"], abs=0.05)
        strict = S.obs.TraceStore(keep_slower_than_ms=1e12,
                                  sample_every=10**6)
        kept = strict.offer(dict(doc, attrs=dict(doc["attrs"])))
        audit(*(h.engine.cache for h in router._replicas))
        return (done[rid].status, doc["status"], doc["attrs"]["failovers"],
                "handoff_ship" in names, "failover_gap" in names,
                names.count("route") >= 2, len(replicas) >= 2,
                any(s["attrs"].get("died") for s in doc["spans"]), kept,
                router.deaths, router.failovers)

    j, t = both(sides, run)
    assert t == j
    assert t == ("ok", "ok", 1, True, True, True, True, True, True, 1, 1)


def test_cancel_mid_handoff_trace_keeps_phase_spans(sides):
    def run(S):
        tr = keep_all(S)
        pe, de, co = pair(S, co_kw=dict(tracer=tr))
        rid = co.submit(PROMPTS[1], max_new_tokens=8)
        co.step()
        pending = len(co._handoffs)
        assert co.cancel(rid) is True
        done = {r.rid: r for r in co.finished()}
        doc = tr.get(str(rid))
        names = [s["name"] for s in doc["spans"]]
        audit(pe.cache, de.cache)
        return (pending, done[rid].status, doc["status"],
                "prefill" in names, "handoff_inflight" in names,
                doc["attrs"]["clocks"]["prefill"] > 0)

    j, t = both(sides, run)
    assert t == j
    assert t == (1, "cancelled", "cancelled", True, True, True)


def _scrape(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def test_http_front_serves_a_disagg_coordinator(sides):
    """``GenerationServer`` over a 1P+1D coordinator: the unified engine's
    tokens over HTTP, ``/health``'s hand-off fields and the
    ``paddle_tpu_disagg_*`` series of ``/metrics`` equal to JAX's front on
    the same requests."""
    def run(S):
        reg = S.obs.MetricsRegistry()
        pe = S.dg.PrefillEngine(S.cfg, S.params, cache(S),
                                metrics_registry=reg)
        de = S.dg.DecodeEngine(S.cfg, S.params, cache(S),
                               metrics_registry=reg)
        co = S.dg.DisaggCoordinator(pe, de, force_route="prefill")
        srv = S.srv.GenerationServer(engine=co)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            got = [S.srv.generate_http(url, [int(x) for x in p], 6)
                   for p in PROMPTS[:3]]
            code, body = _scrape(url + "/health")
            code_m, text = _scrape(url + "/metrics")
        finally:
            srv.stop()
        health = json.loads(body)
        series = {}
        for line in text.decode().splitlines():
            name = line.split(" ")[0]
            if name in DISAGG_SERIES or \
                    name == "paddle_tpu_disagg_handoff_seconds_count":
                series[name] = float(line.split(" ")[1])
        assert srv.tracer is co.tracer is not None
        audit(pe.cache, de.cache)
        return (got, code, code_m,
                {k: health[k] for k in ("handoff_pages", "handoff_inflight",
                                        "disagg_colocated_fallbacks")},
                series)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == unified(sides, PROMPTS[:3], new=6)
    pages = sum(-(-len(p) // 16) for p in PROMPTS[:3])
    assert t[3] == {"handoff_pages": pages, "handoff_inflight": 0,
                    "disagg_colocated_fallbacks": 0}
    assert t[4]["paddle_tpu_disagg_handoff_seconds_count"] == 3


# ---------------------------------------------------------------------------
# the speculative decode engine, and the claim regressions
# ---------------------------------------------------------------------------
def test_spec_disagg_pass_through(sides):
    """A DecodeEngine built with ``spec=`` (prompt lookup) serves its
    hand-off traffic speculatively: token-exact against the plain engine,
    no prefill on the decode side."""
    rng = np.random.RandomState(31)
    specs = [(rng.randint(1, 128, (L,)), 8) for L in (10, 33, 21)]

    def run(S):
        pe = S.dg.PrefillEngine(S.cfg, S.params, cache(S),
                                metrics_registry=False)
        de = S.dg.DecodeEngine(
            S.cfg, S.params, cache(S), metrics_registry=False,
            spec=S.se.SpecConfig(gamma=3, source="prompt_lookup"))
        co = S.dg.DisaggCoordinator(pe, de, metrics_registry=False,
                                    force_route="prefill")
        rids = [co.submit(p, max_new_tokens=n) for p, n in specs]
        done = {r.rid: r for r in co.run_to_completion()}
        audit(pe.cache, de.cache)
        return (tokens(done, rids), de.spec_drafted, de.spec_accepted,
                de.spec_rounds, counters(pe, de, co))

    j, t = both(sides, run)
    assert t == j
    assert t[0] == unified(sides, [p for p, _ in specs])
    assert t[1] > 0 and t[4]["handoff_admits"] == len(specs)
    assert t[4]["decode_prefill_calls"] == 0


def _regression_caches(S):
    pre = S.pd.PagedKVCache(S.cfg, num_pages=64, pages_max=8, batch=2,
                            page=16, host_pages=32, **S.dev)
    dec = S.pd.PagedKVCache(S.cfg, num_pages=32, pages_max=4, batch=2,
                            page=16, host_pages=32, **S.dev)
    return pre, dec


def test_admit_handoff_geometry_mismatch_leaves_audit_clean(sides):
    """The restore half refusing a record the decode rows cannot hold
    raises before adopting: nothing orphaned, the record still whole."""
    def run(S):
        rng = np.random.RandomState(7)
        pre, dec = _regression_caches(S)
        pe = S.dg.PrefillEngine(S.cfg, S.params, pre, metrics_registry=False)
        de = S.dg.DecodeEngine(S.cfg, S.params, dec, metrics_registry=False)
        pe.submit(rng.randint(1, 128, (40,)), max_new_tokens=60)
        for _ in range(50):
            if pe._handoff_ready:
                break
            pe.step()
        recs = pe.take_handoffs()
        with pytest.raises(ValueError):
            de.admit_handoff(recs[0])
        swapped = len(de.cache._swapped)
        de.cache.audit()
        recs[0].discard()
        pe.cache.audit()
        return len(recs), swapped, pe.cache.host.used_pages()

    j, t = both(sides, run)
    assert t == j == (1, 0, 0)


def test_coordinator_commit_window_has_nothing_fallible(sides):
    """A failing placement counter after the engine accepted: the request
    is mapped, so it can still be cancelled and triaged."""
    def run(S):
        rng = np.random.RandomState(8)
        pre, dec = _regression_caches(S)
        pe = S.dg.PrefillEngine(S.cfg, S.params, pre, metrics_registry=False)
        de = S.dg.DecodeEngine(S.cfg, S.params, dec, metrics_registry=False)
        co = S.dg.DisaggCoordinator(pe, de, metrics_registry=False,
                                    force_route="colocated")

        def boom(disagg):
            raise RuntimeError("counter backend down")

        co._count_placement_locked = boom
        with pytest.raises(RuntimeError):
            co.submit(rng.randint(1, 128, (6,)), max_new_tokens=4)
        mapped = len(co._requests)
        rid = next(iter(co._requests))
        cancelled = co.cancel(rid)
        statuses = []
        for _ in range(50):
            if not co.has_work():
                break
            co.step()
            statuses += [r.status for r in co.finished()]
            co.drain_stream()
        audit(de.cache, pe.cache)
        return mapped, cancelled, statuses

    j, t = both(sides, run)
    assert t == j == (1, True, ["cancelled"])
