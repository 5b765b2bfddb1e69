"""The port's dispatch-ahead pipeline (``overlap=True``) and decode horizon
(``decode_horizon=H``) held against paddle_tpu and against the port's own
synchronous lane, on the CPU at the 2-layer fp32 size of
``tests/test_torch_serving_slice.py`` (its weights and helpers; both
frameworks get the same weights through ``params_from_jax``).

Against JAX:

* the async step (``make_paged_decode_step_async``) and the horizon step
  (``make_paged_decode_step_multi``, H = 3) over the same prefilled fp or
  int8 pages: tokens, ``lens'``, ``remaining'``, ``active'`` and ``done``
  equal wherever JAX's top-2 margin is above 1e-3, pools within 1e-4;
* the overlap engine's (and the overlap + horizon engine's) tokens: JAX's
  teacher-forced argmax wherever its margin is above 1e-3, and the JAX
  overlap engine's tokens up to each request's first near-tie;
* eos with the overlap lane, anchored on the JAX overlap engine's output.

The invariants of ``tests/test_serving_overlap.py`` and
``tests/test_serving_horizon.py``, in the port: token-exact against the
synchronous lane (or H = 1) under churn, streaming, eos, stop sequences
(retire, flush, trim and count), recompute preemption mid-flight, no
per-token blocking fetch in the steady state (counted through the
``_dispatch_async`` / ``_fetch`` seams), a row exactly at capacity, one
dispatch and one fetch per block, one ``tables_version`` bump per claim,
the pre-claim clamped by the budget, cancel and deadline audit-clean, the
knob's validation, the HTTP front, and chunked and prefix-cached admission
under the pipeline and the horizon (``alloc_row_prefix`` bumps
``tables_version``, so the graph lanes upload the new tables).

Kept out, each held in its lane's file: speculative rounds, the metrics
registry, wave quarantine (the fault plane) and the host page tier (swap
resumes, ``tests/test_torch_serving_swap.py``); TP meshes are not ported.
On
the CPU the steps run eagerly, through the same body the card replays from
a CUDA graph (``tests/test_torch_serving_overlap_cuda.py`` holds the
graphs there).
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

from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http, generate_http_stream)
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from test_torch_serving_slice import (  # noqa: E402,F401
    PAGE, WAVE, _assert_pages_match, _get, _jax_logits, _jax_packed,
    _pack, _pools, _prefill_wave, _prompts, models)

MARGIN = 1e-3
KW_VOCAB = 128


def _margins(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _jcopy(pools):
    return [jnp.array(p, copy=True) for p in pools]


def _loop_state(rng, B, vocab):
    """A step's input state: one row off, budgets of 1 to 4 (a row runs
    out inside a block), tokens in the vocabulary."""
    tok = rng.integers(0, vocab, B)
    active = np.ones(B, bool)
    active[2] = False
    remaining = np.array([4, 1, 3, 2][:B], np.int32)
    return tok, active, remaining


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_async_step_matches_jax(models, kv_quant):
    jcfg, tcfg, jparams, tparams = models
    st = _prefill_wave(models, kv_quant)
    jc, tc = st["jc"], st["tc"]
    B = len(WAVE)
    jstep = jpd.make_paged_decode_step_async(jcfg, kv_quant=kv_quant)
    jlog = jpd.make_paged_decode_step(jcfg, kv_quant=kv_quant,
                                      with_logits=True)
    tstep = tpd.make_paged_decode_step_async(tcfg, kv_quant=kv_quant)
    rng = np.random.default_rng(0)
    tok, active, remaining = _loop_state(rng, B, KW_VOCAB)
    # the eos fires on whichever row's first token JAX picks for row 0
    key = jax.random.PRNGKey(0)
    eos = -1
    checked = 0
    for step in range(6):
        for b in range(B):
            jc.ensure_capacity(b)
            tc.ensure_capacity(b)
        np.testing.assert_array_equal(jc.tables, tc.tables)
        lens = jc.lens.copy()
        args = (jnp.asarray(jc.tables), jnp.asarray(lens),
                jnp.asarray(tok.astype(np.int32)), jnp.asarray(active),
                jnp.asarray(remaining))
        *_, logits = jlog(jparams, *_jcopy(_pools(jc)), *args[:3], key)
        margin = _margins(logits)
        if step == 1:
            eos = int(np.asarray(logits)[0].argmax())
        *jpools, jn, jl2, jr2, ja2, jd = jstep(
            jparams, *_pools(jc), *args, jnp.asarray(eos, jnp.int32), key)
        if kv_quant == "int8":
            jc.kpool, jc.vpool, jc.kscale, jc.vscale = jpools
        else:
            jc.kpool, jc.vpool = jpools
        *_, tn, tl2, tr2, ta2, td = tstep(
            tparams, *_pools(tc), torch.from_numpy(tc.tables),
            torch.from_numpy(lens), torch.from_numpy(tok.astype(np.int64)),
            torch.from_numpy(active), torch.from_numpy(remaining),
            torch.tensor(eos))
        ok = margin > MARGIN
        checked += int(ok.sum())
        for got, want in ((tn, jn), (tl2, jl2), (tr2, jr2), (ta2, ja2),
                          (td, jd)):
            np.testing.assert_array_equal(got.numpy()[ok],
                                          np.asarray(want)[ok])
        _assert_pages_match(tc, jc)
        # JAX's chain feeds both sides
        tok, active = np.array(jn, np.int64), np.array(ja2)
        remaining = np.array(jr2)
        jc.lens = np.asarray(jl2).astype(np.int32)
        tc.lens = jc.lens.copy()
    assert checked >= 3 * 6


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_multi_step_matches_jax(models, kv_quant):
    """H = 3 micro-steps in one call on each side.  Each micro-step's
    margin comes from JAX's synchronous step with logits run along JAX's
    own chain (the same K/V writes); a row is compared up to its first
    near-tie, the pools when no row has one."""
    jcfg, tcfg, jparams, tparams = models
    st = _prefill_wave(models, kv_quant)
    jc, tc = st["jc"], st["tc"]
    B, H = len(WAVE), 3
    jstep = jpd.make_paged_decode_step_multi(jcfg, H, kv_quant=kv_quant)
    jlog = jpd.make_paged_decode_step(jcfg, kv_quant=kv_quant,
                                      with_logits=True)
    tstep = tpd.make_paged_decode_step_multi(tcfg, H, kv_quant=kv_quant)
    tok, active, remaining = _loop_state(np.random.default_rng(1), B,
                                         KW_VOCAB)
    key = jax.random.PRNGKey(0)
    eos = 5
    for b in range(B):
        jc.ensure_capacity(b, H)
        tc.ensure_capacity(b, H)
    lens = jc.lens.copy()
    tables = jnp.asarray(jc.tables)
    ref_pools = _jcopy(_pools(jc))
    *pools, jtoks, jdones, jtok2, jlens2, jrem2, jact2 = jstep(
        jparams, *_pools(jc), tables, jnp.asarray(lens),
        jnp.asarray(tok), jnp.asarray(active), jnp.asarray(remaining),
        jnp.asarray(eos, jnp.int32), key)
    jtoks, jdones = np.asarray(jtoks), np.asarray(jdones)
    margin = np.zeros((H, B))
    t, ln, act = tok, lens.copy(), active.copy()
    for h in range(H):
        *ref_pools, _, logits = jlog(jparams, *ref_pools, tables,
                                     jnp.asarray(ln), jnp.asarray(t), key)
        margin[h] = _margins(logits)
        t = jtoks[h]
        ln = ln + act
        act = act & ~jdones[h]
    if kv_quant == "int8":
        jc.kpool, jc.vpool, jc.kscale, jc.vscale = pools
    else:
        jc.kpool, jc.vpool = pools
    out = tstep(tparams, *_pools(tc), torch.from_numpy(tc.tables),
                torch.from_numpy(lens), torch.from_numpy(tok),
                torch.from_numpy(active), torch.from_numpy(remaining),
                torch.tensor(eos))
    ttoks, tdones, ttok2, tlens2, trem2, tact2 = out[len(_pools(tc)):]
    assert ttoks.shape == (H, B) and tdones.shape == (H, B)
    whole = []
    for b in range(B):
        good = np.cumprod(margin[:, b] > MARGIN).astype(bool)
        np.testing.assert_array_equal(ttoks.numpy()[good, b],
                                      jtoks[good, b])
        np.testing.assert_array_equal(tdones.numpy()[good, b],
                                      jdones[good, b])
        if good.all():
            whole.append(b)
    assert len(whole) >= 2
    for got, want in ((ttok2, jtok2), (tlens2, jlens2), (trem2, jrem2),
                      (tact2, jact2)):
        np.testing.assert_array_equal(got.numpy()[whole],
                                      np.asarray(want)[whole])
    if len(whole) == B:
        _assert_pages_match(tc, jc)


# -- the engine: helpers ------------------------------------------------------
def _cache(tcfg, batch=2, num_pages=64, pages_max=8, kv_quant=None):
    return tpd.PagedKVCache(tcfg, num_pages=num_pages, pages_max=pages_max,
                            batch=batch, page=PAGE, kv_quant=kv_quant,
                            device="cpu")


def _engine(tcfg, tparams, batch=2, num_pages=64, pages_max=8,
            kv_quant=None, **kw):
    cache = _cache(tcfg, batch, num_pages, pages_max, kv_quant)
    return ContinuousBatchingEngine(tcfg, tparams, cache, **kw), cache


def _run(tcfg, tparams, specs, batch=2, num_pages=64, kv_quant=None,
         stops=None, **kw):
    """Serve ``specs`` ((prompt, max_new) pairs) to the end; the pool must
    drain audit-clean.  -> ({rid: tokens}, engine)."""
    eng, cache = _engine(tcfg, tparams, batch, num_pages, kv_quant=kv_quant,
                         **kw)
    for p, n in specs:
        eng.submit(p, max_new_tokens=n, stop_sequences=stops)
    done = eng.run_to_completion()
    assert cache.audit() == {"free": cache.num_pages - 1, "owned": 0,
                             "indexed": 0}
    assert not eng._inflight
    return {r.rid: list(r.generated) for r in done}, eng


_REF = {}


def _ref(tcfg, tparams, specs, **kw):
    """:func:`_run` of a synchronous reference, served once per module for
    each set of arguments (several cases share one) -> ({rid: tokens},
    engine)."""
    key = (tuple((tuple(int(t) for t in p), n) for p, n in specs),
           tuple(sorted((k, repr(v)) for k, v in kw.items())))
    if key not in _REF:
        _REF[key] = _run(tcfg, tparams, specs, **kw)
    got, eng = _REF[key]
    return {k: list(v) for k, v in got.items()}, eng


def _churn(seed=0, n=5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 128, (int(rng.randint(3, 20)),)),
             int(rng.randint(2, 9))) for _ in range(n)]


def _jax_engine(models, kv_quant=None, batch=2, **kw):
    jcfg, _, jparams, _ = models
    cache = jpd.PagedKVCache(jcfg, num_pages=64, pages_max=8, batch=batch,
                             page=PAGE, kv_quant=kv_quant)
    return jse.ContinuousBatchingEngine(jcfg, jparams, cache, **kw)


# -- the engine against JAX ---------------------------------------------------
@pytest.mark.parametrize("lane", [dict(overlap=True),
                                  dict(overlap=True, decode_horizon=4)],
                         ids=["overlap", "overlap-h4"])
def test_overlap_engine_matches_jax_overlap_engine(models, lane):
    jcfg, tcfg, jparams, tparams = models
    prompts = _prompts([5, 16, 1, 33, 20], seed=1)
    news = [8, 6, 9, 5, 7]
    specs = list(zip(prompts, news))
    got, eng = _run(tcfg, tparams, specs, batch=4, **lane)
    assert eng.pipeline_flushes >= 1         # admission waves flush
    jeng = _jax_engine(models, batch=4, **lane)
    for p, n in specs:
        jeng.submit(p, max_new_tokens=n)
    jgot = {r.rid: list(r.generated) for r in jeng.run_to_completion()}
    # JAX's teacher-forced logits over the port's sequences
    seqs = [np.concatenate([p, got[i][:-1]]).astype(np.int32)
            for i, p in enumerate(prompts)]
    toks, seg, pos, offs = _pack(seqs)
    jx, _, _ = _jax_packed(jcfg, jparams, toks, seg, pos)
    logits = _jax_logits(jcfg, jparams, jx[0])
    checked = 0
    for i, (p, off) in enumerate(zip(prompts, offs)):
        rows = logits[off + len(p) - 1:off + len(p) - 1 + len(got[i])]
        margin = _margins(rows)
        for j, t in enumerate(got[i]):
            if margin[j] > MARGIN:
                checked += 1
                assert t == int(rows[j].argmax()), (i, j)
        # the JAX overlap engine's tokens up to the first near-tie
        tie = next((j for j in range(len(got[i])) if margin[j] <= MARGIN),
                   len(got[i]))
        assert got[i][:tie] == jgot[i][:tie], i
    assert checked >= sum(news) // 2


def test_overlap_eos_stops_early_as_the_jax_engine(models):
    """The eos is the first token the JAX synchronous engine gives after
    its first that differs from it; the JAX overlap engine stops there,
    and the port's lanes give the JAX overlap engine's tokens."""
    _, tcfg, _, tparams = models
    prompt = np.random.RandomState(2).randint(1, 128, (6,))
    jeng = _jax_engine(models, batch=1)
    jeng.submit(prompt, max_new_tokens=8)
    ref = list(jeng.run_to_completion()[0].generated)
    k = next(j for j, t in enumerate(ref) if t != ref[0])
    eos = int(ref[k])
    jeng = _jax_engine(models, batch=1, eos_id=eos, overlap=True)
    jeng.submit(prompt, max_new_tokens=10)
    jout = list(jeng.run_to_completion()[0].generated)
    assert jout == ref[:k + 1] and len(jout) < 10
    for lane in (dict(), dict(overlap=True),
                 dict(overlap=True, decode_horizon=4)):
        got, _ = _run(tcfg, tparams, [(prompt, 10)], batch=1, eos_id=eos,
                      **lane)
        assert got[0] == jout, lane


# -- the invariants of tests/test_serving_overlap.py --------------------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_overlap_token_exact_vs_sync_under_churn(models, kv_quant):
    _, tcfg, _, tparams = models
    specs = _churn()
    ref, _ = _ref(tcfg, tparams, specs, kv_quant=kv_quant)
    for lookahead in (1, 3):
        got, eng = _run(tcfg, tparams, specs, kv_quant=kv_quant,
                        overlap=True, lookahead=lookahead)
        assert got == ref, lookahead
        assert eng.host_syncs > 0 and eng.decode_steps > 0


def test_overlap_streaming_matches_finished_generations(models):
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(1)
    eng, _ = _engine(tcfg, tparams, overlap=True)
    r1 = eng.submit(rng.randint(1, 128, (10,)), max_new_tokens=6)
    r2 = eng.submit(rng.randint(1, 128, (7,)), max_new_tokens=4)
    streamed = {r1: [], r2: []}
    finished = {}
    while eng.has_work():
        eng.step()
        for rid, t in eng.drain_stream():
            streamed[rid].append(t)
        finished.update({r.rid: r for r in eng.finished()})
    for rid, toks in streamed.items():
        assert toks == finished[rid].generated


@pytest.mark.parametrize("H", [1, 4])
def test_overlap_stop_sequence_retires_and_flushes(models, H):
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(3)
    p1, p2 = rng.randint(1, 128, (9,)), rng.randint(1, 128, (7,))
    ref, _ = _ref(tcfg, tparams, [(p1, 12), (p2, 12)])
    stop = ref[0][3:5]                       # completes at token 5
    eng, cache = _engine(tcfg, tparams, overlap=True, decode_horizon=H)
    r1 = eng.submit(p1, max_new_tokens=12, stop_sequences=[stop])
    r2 = eng.submit(p2, max_new_tokens=12)
    done = {r.rid: list(r.generated) for r in eng.run_to_completion()}
    assert done[r1] == ref[0][:5]
    assert done[r2] == ref[1]
    assert eng.pipeline_flushes >= 1, \
        "a host-only retirement must flush the pipeline"
    assert cache.audit()["owned"] == 0


@pytest.mark.parametrize("H", [1, 4])
def test_overlap_preemption_midflight_token_exact(models, H):
    """Pool exhaustion with dispatches in flight: the pipeline drains
    before the victim is evicted, the victim resumes by recompute, and
    both requests equal their solo synchronous runs."""
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 128, (16,)) for _ in range(2)]
    eng, cache = _engine(tcfg, tparams, num_pages=5, pages_max=4,
                         overlap=True, decode_horizon=H)
    for p in prompts:
        eng.submit(p, max_new_tokens=20)
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    assert any(r.preempted > 0 for r in done), \
        "the pool was sized to force preemption"
    for req, p in zip(done, prompts):
        solo, _ = _ref(tcfg, tparams, [(p, 20)], batch=1)
        assert list(req.generated) == solo[0]
    assert cache.audit() == {"free": 4, "owned": 0, "indexed": 0}


def test_overlap_steady_state_no_per_token_blocking_sync(models):
    """Every fetch lands with a newer dispatch already issued, one fetch a
    dispatch, no flush, nothing left in flight."""
    _, tcfg, _, tparams = models
    prompt = np.random.RandomState(8).randint(1, 128, (10,))
    new = 24
    solo, _ = _run(tcfg, tparams, [(prompt, new)], batch=1)
    eng, _ = _engine(tcfg, tparams, batch=1, overlap=True)
    events = []
    dispatch, fetch = eng._dispatch_async, eng._fetch

    def counting_dispatch():
        events.append("dispatch")
        return dispatch()

    def counting_fetch(*arrs):
        events.append("fetch")
        return fetch(*arrs)

    eng._dispatch_async = counting_dispatch
    eng._fetch = counting_fetch
    eng.submit(prompt, max_new_tokens=new)
    done = eng.run_to_completion()
    assert list(done[0].generated) == solo[0]
    assert eng.pipeline_flushes == 0
    dispatched = 0
    depth = []                      # dispatches ahead of the host a fetch
    for ev in events:
        if ev == "dispatch":
            dispatched += 1
        else:
            depth.append(dispatched - len(depth))
    assert all(d >= 2 for d in depth[:-eng.lookahead]), depth
    assert len(depth) == dispatched == eng.host_syncs
    assert not eng._inflight
    assert len(depth) >= new - 2


@pytest.mark.parametrize("lookahead", [1, 3])
def test_overlap_exactly_sized_request_at_row_capacity(models, lookahead):
    """prompt + max_new == pages_max * page: the host lens mirror of the
    dead, undrained row runs past the table and must not trip the claim;
    the step's table read clamps as JAX's gather does."""
    _, tcfg, _, tparams = models
    prompt = np.random.RandomState(11).randint(1, 128, (16,))
    solo, _ = _ref(tcfg, tparams, [(prompt, 48)], batch=1)
    eng, cache = _engine(tcfg, tparams, batch=1, num_pages=32, pages_max=4,
                         overlap=True, lookahead=lookahead)
    eng.submit(prompt, max_new_tokens=48)          # 16 + 48 == 64
    assert list(eng.run_to_completion()[0].generated) == solo[0]
    assert cache.free_pages() == cache.num_pages - 1


def test_overlap_chunked_prefill_and_prefix_caching(models):
    """Chunked and prefix-cached admission compose with the pipeline
    (admission flushes it): a long prompt over a 32-token chunk and two
    requests sharing a 3-page prefix stay token-exact against the
    synchronous lane, and the cached pages are still reused."""
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(5)
    p80 = rng.randint(1, 128, (80,))
    want, _ = _run(tcfg, tparams, [(p80, 6)], batch=1)
    eng, cache = _engine(tcfg, tparams, num_pages=32, prefill_chunk=32,
                         packed=False, overlap=True)
    eng.submit(p80, max_new_tokens=6)
    assert eng.run_to_completion()[0].generated == want[0]
    assert eng.prefill_calls == 3
    prefix = rng.randint(1, 128, (48,))
    specs = [(np.concatenate([prefix, rng.randint(1, 128, (L,))]), 5)
             for L in (5, 9)]
    want, _ = _run(tcfg, tparams, specs)
    for packed in (True, False):
        eng, cache = _engine(tcfg, tparams, enable_prefix_caching=True,
                             packed=packed, overlap=True)
        for p, n in specs:
            eng.submit(p, max_new_tokens=n)
        done = {r.rid: list(r.generated) for r in eng.run_to_completion()}
        assert done == want, packed
        assert cache.prefix_hits == 3
        assert cache.audit() == {"free": 63 - 3, "owned": 0, "indexed": 3}
        assert not eng._inflight


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_horizon_prefix_cache_token_exact(models, kv_quant):
    """Prefix-cache admissions (shared pages + suffix prefill) compose with
    the horizon and the pipeline: the shared pages stay shared across the
    pre-claimed block, and H = 4 gives H = 1's tokens."""
    _, tcfg, _, tparams = models

    def run(H):
        eng, cache = _engine(tcfg, tparams, decode_horizon=H, overlap=True,
                             enable_prefix_caching=True, prefill_chunk=32,
                             kv_quant=kv_quant)
        rng = np.random.RandomState(5)
        base = rng.randint(1, 128, (34,))
        eng.submit(base, max_new_tokens=6)
        eng.submit(np.concatenate([base[:32], rng.randint(1, 128, (4,))]),
                   max_new_tokens=6)
        got = {r.rid: list(r.generated) for r in eng.run_to_completion()}
        cache.audit()
        return got, cache

    ref, _ = run(1)
    got, cache = run(4)
    assert got == ref
    assert cache.prefix_hits > 0


# -- the invariants of tests/test_serving_horizon.py --------------------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_horizon_token_exact_vs_h1_churn(models, kv_quant):
    _, tcfg, _, tparams = models
    specs = _churn()
    ref, _ = _ref(tcfg, tparams, specs, kv_quant=kv_quant)
    for H, overlap in ((2, False), (2, True), (4, False), (4, True)):
        got, _ = _run(tcfg, tparams, specs, kv_quant=kv_quant,
                      decode_horizon=H, overlap=overlap)
        assert got == ref, (H, overlap)


def _one_row(models):
    _, tcfg, _, tparams = models
    prompt = np.random.RandomState(3).randint(1, 128, (8,))
    ref, _ = _ref(tcfg, tparams, [(prompt, 12)], batch=1)
    return tcfg, tparams, prompt, ref[0]


def test_horizon_eos_mid_block(models):
    tcfg, tparams, prompt, ref = _one_row(models)
    eos = int(ref[4])                 # fires mid-block at H = 4 and 8
    want, _ = _run(tcfg, tparams, [(prompt, 12)], batch=1, eos_id=eos)
    assert len(want[0]) < 12
    for H, overlap in ((4, True), (8, False)):
        got, _ = _run(tcfg, tparams, [(prompt, 12)], batch=1, eos_id=eos,
                      decode_horizon=H, overlap=overlap)
        assert got == want, (H, overlap)


def test_horizon_stop_sequence_trims_and_counts(models):
    tcfg, tparams, prompt, ref = _one_row(models)
    stop = [[int(ref[2]), int(ref[3])]]
    got1, eng1 = _run(tcfg, tparams, [(prompt, 12)], batch=1, stops=stop)
    assert got1[0] == ref[:4] and eng1.horizon_trimmed_tokens == 0
    for H, overlap in ((4, False), (4, True), (8, True)):
        got, eng = _run(tcfg, tparams, [(prompt, 12)], batch=1, stops=stop,
                        decode_horizon=H, overlap=overlap)
        assert got == got1
        # the stop completes at decode token 3, micro-step 2 of the first
        # block: the device generated the block's other H - 3
        assert eng.horizon_trimmed_tokens == H - 3


def test_horizon_preemption_token_exact(models):
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(9)
    specs = [(rng.randint(1, 128, (L,)), 30) for L in (40, 44)]
    ref, _ = _run(tcfg, tparams, specs, num_pages=9)
    got, eng = _run(tcfg, tparams, specs, num_pages=9, decode_horizon=4,
                    overlap=True)
    assert got == ref
    assert eng.preemptions > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_horizon_one_dispatch_and_fetch_per_block(models, overlap):
    """8 decode tokens at H = 4: 2 blocks (overlap: + the one chained
    lookahead block in flight when the done drained), each one dispatch
    and one fetch of the [H, B] tokens and done flags together."""
    _, tcfg, _, tparams = models
    eng, _ = _engine(tcfg, tparams, batch=1, decode_horizon=4,
                     overlap=overlap)
    fetches = []
    fetch = eng._fetch
    eng._fetch = lambda event, *a: fetches.append(len(a)) or fetch(event, *a)
    eng.submit(np.random.RandomState(1).randint(1, 128, (10,)),
               max_new_tokens=9)
    assert len(eng.run_to_completion()[0].generated) == 9
    blocks = 3 if overlap else 2
    assert eng.decode_steps == blocks
    assert fetches == [2] * blocks
    assert eng.host_syncs == blocks


def test_horizon_batched_capacity_one_version_bump(models):
    _, tcfg, _, tparams = models
    eng, cache = _engine(tcfg, tparams, decode_horizon=8, overlap=True)
    calls = {"batch": 0, "single": 0, "multi_bump": 0}
    batch, single = cache.ensure_capacity_batch, cache.ensure_capacity

    def counting_batch(needs):
        calls["batch"] += 1
        v0 = cache.tables_version
        batch(needs)
        calls["multi_bump"] += cache.tables_version - v0 > 1

    def counting_single(b, new_tokens=1):
        calls["single"] += 1
        single(b, new_tokens)

    cache.ensure_capacity_batch = counting_batch
    cache.ensure_capacity = counting_single
    rng = np.random.RandomState(2)
    for _ in range(2):
        eng.submit(rng.randint(1, 128, (14,)), max_new_tokens=20)
    eng.run_to_completion()
    assert cache.free_pages() == cache.num_pages - 1
    assert calls["batch"] > 0 and calls["single"] == 0
    assert calls["multi_bump"] == 0
    # one claim grows both rows with one bump; a claim that grows nothing
    # bumps nothing
    c2 = _cache(tcfg)
    c2.alloc_row(0, 10)
    c2.alloc_row(1, 12)
    v0 = c2.tables_version
    c2.ensure_capacity_batch([(0, 16), (1, 16)])
    assert c2.tables_version == v0 + 1
    assert len(c2._owned[0]) == 2 and len(c2._owned[1]) == 2
    c2.ensure_capacity_batch([(0, 16), (1, 16)])
    assert c2.tables_version == v0 + 1
    c2.release_row(0)
    assert c2.tables_version == v0 + 2


def test_horizon_preclaim_clamped_by_remaining(models):
    """prompt 100 + 28 new == the row's 128 slots, with remaining < H at
    the tail: the pre-claim clamps to the budget and the table."""
    _, tcfg, _, tparams = models
    prompt = np.random.RandomState(4).randint(1, 128, (100,))
    got, eng = _run(tcfg, tparams, [(prompt, 28)], batch=1,
                    decode_horizon=8, overlap=True)
    assert len(got[0]) == 28


def test_horizon_cancel_and_deadline_audit_clean(models):
    _, tcfg, _, tparams = models
    eng, cache = _engine(tcfg, tparams, decode_horizon=4, overlap=True)
    now = [1000.0]
    eng._now = lambda: now[0]
    rng = np.random.RandomState(6)
    r1 = eng.submit(rng.randint(1, 128, (10,)), max_new_tokens=40)
    r2 = eng.submit(rng.randint(1, 128, (12,)), max_new_tokens=40,
                    deadline_s=5.0)
    eng.step()
    eng.step()
    eng.cancel(r1)
    now[0] += 10.0                    # r2's deadline passes
    by = {r.rid: r for r in eng.run_to_completion()}
    assert by[r1].status == "cancelled" and by[r2].status == "expired"
    assert len(by[r1].generated) < 40 and len(by[r2].generated) < 40
    assert eng.pipeline_flushes >= 1
    assert cache.audit() == {"free": cache.num_pages - 1, "owned": 0,
                             "indexed": 0}


def test_horizon_invalid_value_and_lanes_rejected(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="decode_horizon"):
        _engine(tcfg, tparams, decode_horizon=0)
    with pytest.raises(ValueError, match="mixed tick re-plans"):
        _engine(tcfg, tparams, mixed=True, decode_horizon=4)
    with pytest.raises(ValueError, match="tune spec.gamma instead"):
        _engine(tcfg, tparams, spec=object(), decode_horizon=4)
    # mixed=True with overlap=True is ported: it builds and serves
    # (tests/test_torch_serving_mixed.py holds the lane)
    specs = [(p, 6) for p in _prompts([9, 21, 40], seed=4)]
    want, _ = _run(tcfg, tparams, specs)
    got, eng = _run(tcfg, tparams, specs, mixed=True, mixed_token_budget=16,
                    overlap=True)
    assert got == want and eng.overlap and eng._mixed
    with pytest.raises(ValueError, match="horizon"):
        tpd.make_paged_decode_step_multi(tcfg, 0)
    with pytest.raises(NotImplementedError, match="TP"):
        tpd.make_paged_decode_step_async(tcfg, mesh=object())


# -- the HTTP front -----------------------------------------------------------
def test_http_front_overlap_horizon_serves_sync_tokens(models):
    _, tcfg, _, tparams = models
    prompt = [int(t) for t in _prompts([7], seed=3)[0]]
    want, _ = _run(tcfg, tparams, [(prompt, 6)], batch=1)
    srv = GenerationServer(tcfg, tparams, _cache(tcfg, batch=4),
                           overlap=True, decode_horizon=4)
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        assert generate_http(url, prompt, 6) == want[0]
        assert list(generate_http_stream(url, prompt, 6)) == want[0]
        code, body, _ = _get(url + "/health")
        doc = json.loads(body)
        assert code == 200 and doc["decode_horizon"] == 4
        assert doc["horizon_trimmed_tokens"] == 0
        assert doc["host_syncs"] >= 2
        assert doc["pipeline_flushes"] == srv.engine.pipeline_flushes
    finally:
        srv.stop()
    assert srv.engine.cache.audit()["owned"] == 0
    assert not srv.engine._inflight


# -- the graph cache's key ----------------------------------------------------
def test_decode_graph_key_follows_flags_and_tensors(models):
    """One DecodeGraph per key: the same call finds it again; a flag flip,
    another pool tensor or another horizon makes another (on the card each
    is its own capture)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import graphed_step as gs
    _, tcfg, _, tparams = models
    cache = _cache(tcfg)
    pools = _pools(cache)
    dev = torch.device("cpu")

    def graph(H=1, pools=pools):
        return gs.decode_graph(tcfg, H, H > 1, 0.0, None, 0, 1.0, tparams,
                               pools, 2, 8, dev)

    g = graph()
    assert graph() is g
    assert graph(H=2) is not g
    assert graph(pools=(cache.kpool.clone(), cache.vpool)) is not g
    saved = flags.get_flags(["FLAGS_pallas_swiglu"])
    try:
        flags.set_flags({"FLAGS_pallas_swiglu": True})
        assert graph() is not g
    finally:
        flags.set_flags(saved)
    assert graph() is g


def test_sampling_runs_on_the_overlap_and_horizon_lanes(models):
    _, tcfg, _, tparams = models
    specs = _churn(seed=5, n=3)
    for lane in (dict(overlap=True), dict(decode_horizon=3),
                 dict(overlap=True, decode_horizon=3)):
        got, _ = _run(tcfg, tparams, specs, temperature=0.9, top_k=20,
                      seed=3, **lane)
        for (p, n), toks in zip(specs, got.values()):
            assert len(toks) == n
            assert all(0 <= t < KW_VOCAB for t in toks)
