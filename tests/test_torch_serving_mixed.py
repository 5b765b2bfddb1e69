"""The port's mixed prefill + decode tick (``mixed=True``) held against
paddle_tpu's on the CPU, at the 2-layer fp32 config of
``tests/test_serving_mixed.py`` with the same weights (``params_from_jax``)
and the same numpy-seeded prompts.

Against JAX:

* ``make_mixed_step`` on one set of inputs (two decode rows, one of which
  runs out of budget; a fresh segment that samples its first token; a
  resumed segment with two pages of history that takes its saved token):
  ``nxt``, ``lens'``, ``remaining'``, ``active'``, ``done`` and ``ftok``
  equal, the written pages within 1e-5 (page 0, the junk page, left out);
  with int8 pages the codes equal and the scales within 1e-6;
* the mixed engine rid for rid token-equal to JAX's mixed engine and to the
  port's sequential packed lane, fp and int8 pages, sync and overlap, with
  ``mixed_ticks``, ``mixed_prefill_tokens``, ``mixed_degraded``,
  ``prefill_token_slots``, ``prefill_padded_tokens``, ``decode_steps`` and
  ``host_syncs`` equal to JAX's.

The invariants of ``tests/test_serving_mixed.py``, in the port: chunked
long prompts, prefix caching (exact, with hits), recompute preemption, one
call a tick with no prefill dispatch and no ``write_pages_batch`` once a
row is parked, the budget's accounting, one ``_fetch`` a dispatch on both
lanes, budget 0 and the context cap degrading, an idle engine admitting
sequentially, a first-token eos, a step fault that quarantines the parked
rows with the decode rows, cancel and deadline mid-prefill, a supervisor
restart failing parked rows, a parked row as the preemption victim, and
the registry's and the HTTP front's mixed counters.
``PagedKVCache.audit()`` is clean after every engine case.

The host-tier case (swap resumes through the carve) is held in
``tests/test_torch_serving_swap.py``, the mixed-capable hand-off cost of
disaggregation in ``tests/test_torch_disagg.py``.  JAX's TP-mesh cases
wait for ROADMAP.md queue 1 item 7.
"""

import json
import threading
import time

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
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http)
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine, EngineSupervisor)
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402
from test_torch_serving_slice import _get  # noqa: E402

pytestmark = pytest.mark.mixed

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
PAGE = 16
CACHE = dict(num_pages=64, pages_max=8, batch=3, page=PAGE)
MIXED = dict(mixed=True, mixed_token_budget=16)
COUNTERS = ("mixed_ticks", "mixed_prefill_tokens", "mixed_degraded",
            "prefill_token_slots", "prefill_padded_tokens", "decode_steps",
            "host_syncs")


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


def _specs(seed=0, n=6, lo=3, hi=30, new_lo=2, new_hi=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 128, (int(rng.randint(lo, hi)),)),
             int(rng.randint(new_lo, new_hi)))
            for _ in range(n)]


def _serve(eng, specs, stagger):
    """tests/test_serving_mixed.py's drive: with ``stagger`` two requests
    admit first (a resident batch) and the rest arrive while they decode,
    so their tokens ride inside live decode dispatches."""
    if stagger:
        for p, n in specs[:2]:
            eng.submit(p, max_new_tokens=n)
        eng.step()
        for p, n in specs[2:]:
            eng.submit(p, max_new_tokens=n)
    else:
        for p, n in specs:
            eng.submit(p, max_new_tokens=n)
    done = eng.run_to_completion(max_steps=100_000)
    return {r.rid: list(r.generated) for r in done}


def _run(models, specs, cache_kw=None, stagger=False, **kw):
    _, tcfg, _, tparams = models
    cache = tpd.PagedKVCache(tcfg, device="cpu",
                             **dict(CACHE, **(cache_kw or {})))
    kw.setdefault("metrics_registry", False)
    eng = ContinuousBatchingEngine(tcfg, tparams, cache, **kw)
    got = _serve(eng, specs, stagger)
    cache.audit()
    if not kw.get("enable_prefix_caching"):
        assert cache.free_pages() == cache.num_pages - 1
    return got, eng


_REF = {}


def _ref(models, specs, cache_kw=None, stagger=False, **kw):
    """:func:`_run` of a reference lane, run once per module for each set
    of arguments (several cases share one reference) -> (tokens, its
    engine)."""
    key = (tuple((tuple(int(t) for t in p), n) for p, n in specs),
           tuple(sorted((cache_kw or {}).items())), stagger,
           tuple(sorted(kw.items())))
    if key not in _REF:
        _REF[key] = _run(models, specs, cache_kw=cache_kw, stagger=stagger,
                         **kw)
    got, eng = _REF[key]
    return {k: list(v) for k, v in got.items()}, eng


def _run_jax(models, specs, cache_kw=None, stagger=False, **kw):
    jcfg, _, jparams, _ = models
    cache = jpd.PagedKVCache(jcfg, **dict(CACHE, **(cache_kw or {})))
    kw.setdefault("metrics_registry", False)
    eng = jse.ContinuousBatchingEngine(jcfg, jparams, cache, **kw)
    got = _serve(eng, specs, stagger)
    cache.audit()
    return got, eng


# -- the module ------------------------------------------------------------
def _mixed_inputs(models, kv_quant):
    """Both caches with rows 0 and 1 prefilled and decoding, row 2 parked
    fresh (20 prompt tokens, the whole context in this tick) and row 3
    parked as a resume: 32 tokens written (two pages of history), 11 more
    in this tick, its saved next input ``p_first``.  -> (jax caches, port
    caches, the stream's and the loop state's numpy arrays)."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.RandomState(41)
    B = 4
    jc = jpd.PagedKVCache(jcfg, num_pages=32, pages_max=4, batch=B,
                          page=PAGE, kv_quant=kv_quant)
    tc = tpd.PagedKVCache(tcfg, num_pages=32, pages_max=4, batch=B,
                          page=PAGE, kv_quant=kv_quant, device="cpu")
    first = [rng.randint(1, 128, (L,)) for L in (7, 16, 1, 32)]
    # a packed wave writes rows 0-3 (row 3: its 32-token history)
    T = 128
    toks = np.zeros((1, T), np.int32)
    seg = np.full((1, T), 4, np.int32)
    pos = np.zeros((1, T), np.int32)
    off, spans = 0, []
    for i, p in enumerate(first):
        W = -(-len(p) // PAGE) * PAGE
        seg[0, off:off + W] = i
        pos[0, off:off + W] = np.arange(W)
        toks[0, off:off + len(p)] = p
        spans.append((i, off, W, len(p)))
        off += W
    for c in (jc, tc):
        for i, p in enumerate(first):
            c.alloc_row(i, len(p))
    q8 = kv_quant == "int8"
    T0 = toks.shape[1]
    zi, zb = jnp.zeros((T0,), jnp.int32), jnp.zeros((T0,), bool)
    pool = jnp.zeros((2, 2, 2, PAGE, 16), jnp.int8 if q8 else jnp.float32)
    sc = (jnp.ones((2, 2, 2, PAGE), jnp.float32) if q8
          else jnp.zeros((1,), jnp.float32))
    _, jks, jvs = jax.jit(jpd._packed_prefill_body(jcfg, q8, False))(
        jparams, jnp.asarray(toks), jnp.asarray(seg), jnp.asarray(pos),
        pool, pool, sc, sc, zi, zi, zb, zi, zb)
    jc.write_pages_batch([(s, jks[:, o:o + W], jvs[:, o:o + W], L, 0)
                          for s, o, W, L in spans])
    # the port's pages start as JAX's, so only this tick is compared
    for name in ("kpool", "vpool", "kscale", "vscale"):
        if getattr(jc, name) is not None:
            getattr(tc, name).copy_(torch.from_numpy(
                np.array(getattr(jc, name))))
    # row 2 parks a fresh 20-token prompt; row 3 grows to 43 tokens
    for c in (jc, tc):
        c.alloc_row(2, 20)
    np.testing.assert_array_equal(jc.tables, tc.tables)
    ctx2 = rng.randint(1, 128, (20,))
    ctx3 = np.concatenate([first[3], rng.randint(1, 128, (11,))])
    Tb = 128
    s = dict(p_toks=np.zeros((1, Tb), np.int32),
             p_seg=np.full((1, Tb), 2, np.int32),
             p_pos=np.zeros((1, Tb), np.int32),
             hist_page=np.zeros((Tb,), np.int32),
             hist_slot=np.zeros((Tb,), np.int32),
             pool_hist=np.zeros((Tb,), bool),
             dest_page=np.zeros((Tb,), np.int32),
             dest_slot=np.zeros((Tb,), np.int32),
             sample_idx=np.zeros((B,), np.int32),
             activate=np.zeros((B,), bool),
             p_first=np.zeros((B,), np.int32),
             p_sample=np.zeros((B,), bool),
             p_len=np.zeros((B,), np.int32),
             p_rem=np.zeros((B,), np.int32))
    # segment 0: row 2, [fresh 20 | pad 12]
    s["p_seg"][0, :32] = 0
    s["p_pos"][0, :32] = np.arange(32)
    s["p_toks"][0, :20] = ctx2
    for j in range(2):
        s["dest_page"][j * PAGE:(j + 1) * PAGE] = jc.tables[2, j]
        s["dest_slot"][j * PAGE:(j + 1) * PAGE] = np.arange(PAGE)
    s["activate"][2] = s["p_sample"][2] = True
    s["sample_idx"][2] = 19
    s["p_len"][2], s["p_rem"][2] = 20, 7
    # segment 1: row 3, [history 32 | fresh 11 | pad 5] at offset 32
    s["p_seg"][0, 32:80] = 1
    s["p_pos"][0, 32:80] = np.arange(48)
    s["p_toks"][0, 64:75] = ctx3[32:]
    for j in range(2):
        a = 32 + j * PAGE
        s["hist_page"][a:a + PAGE] = jc.tables[3, j]
        s["hist_slot"][a:a + PAGE] = np.arange(PAGE)
        s["pool_hist"][a:a + PAGE] = True
    s["dest_page"][64:80] = jc.tables[3, 2]
    s["dest_slot"][64:80] = np.arange(PAGE)
    s["activate"][3] = True
    s["p_first"][3] = 77
    s["p_len"][3], s["p_rem"][3] = 43, 5
    state = dict(tables=jc.tables.copy(), lens=jc.lens.copy(),
                 tok=np.array([5, 9, 0, 0], np.int32),
                 active=np.array([True, True, False, False]),
                 remaining=np.array([3, 1, 0, 0], np.int32))
    # the decode rows' pages for this token
    for c in (jc, tc):
        c.ensure_capacity_batch([(0, 1), (1, 1)])
    state["tables"] = jc.tables.copy()
    np.testing.assert_array_equal(jc.tables, tc.tables)
    return jc, tc, s, state


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_mixed_step_matches_jax(models, kv_quant):
    jcfg, tcfg, jparams, tparams = models
    q8 = kv_quant == "int8"
    jc, tc, s, st = _mixed_inputs(models, kv_quant)
    names = ("kpool", "vpool", "kscale", "vscale") if q8 else \
        ("kpool", "vpool")
    jpools = [jnp.array(getattr(jc, n), copy=True) for n in names]
    tpools = [getattr(tc, n) for n in names]
    before = [p.clone() for p in tpools]
    order = ("p_toks", "p_seg", "p_pos", "hist_page", "hist_slot",
             "pool_hist", "dest_page", "dest_slot", "sample_idx", "activate",
             "p_first", "p_sample", "p_len", "p_rem")
    loop = ("tables", "lens", "tok", "active", "remaining")
    eos = 9
    jfn = jpd.make_mixed_step(jcfg, kv_quant=kv_quant)
    jout = jfn(jparams, *jpools, *(jnp.asarray(st[k]) for k in loop),
               jnp.asarray(eos, jnp.int32), jax.random.PRNGKey(0),
               *(jnp.asarray(s[k]) for k in order))
    tfn = tpd.make_mixed_step(tcfg, kv_quant=kv_quant)
    assert tpd.make_mixed_step(tcfg, kv_quant=kv_quant) is tfn  # memoised
    tout = tfn(tparams, *tpools, *(torch.from_numpy(st[k]) for k in loop),
               torch.tensor(eos), None,
               *(torch.from_numpy(s[k]) for k in order))
    n = len(names)
    for k, (got, want) in enumerate(zip(tout[n:], jout[n:])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"output {k}")
    nxt, lens2, rem2, act2, done, ftok = (t.numpy() for t in tout[n:])
    # row 1 spent its budget; row 2 took its sampled token, row 3 p_first
    assert done.tolist() == [False, True, False, False]
    assert act2.tolist() == [True, False, True, True]
    assert lens2.tolist()[2:] == [20, 43] and rem2.tolist()[2:] == [7, 5]
    assert ftok[3] == 77 and nxt[2] == ftok[2] and nxt[3] == 77
    # the pools were written in place; page 0 (junk) is left out
    for got, want, old in zip(tpools, jout[:n], before):
        want = np.asarray(want)
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(got.numpy()[:, 1:], want[:, 1:])
        elif got.dim() == 4:                     # the int8 pages' scales
            np.testing.assert_allclose(got.numpy()[:, 1:], want[:, 1:],
                                       atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(got.numpy()[:, 1:], want[:, 1:],
                                       atol=1e-5, rtol=0)
        assert not torch.equal(got[:, 1:], old[:, 1:])
    # history pages 0-1 of row 3 stay as written; its third page took the
    # chunk; row 2's two pages took the fresh prompt
    t3 = tc.tables[3]
    assert torch.equal(tpools[0][:, t3[:2]], before[0][:, t3[:2]])
    for page in (tc.tables[2, 0], tc.tables[2, 1], t3[2]):
        assert not torch.equal(tpools[0][:, page], before[0][:, page])


def test_mixed_step_refuses_a_mesh(models):
    _, tcfg, _, _ = models
    with pytest.raises(NotImplementedError, match="TP"):
        tpd.make_mixed_step(tcfg, mesh=object())
    with pytest.raises(ValueError, match="kv_quant"):
        tpd.make_mixed_step(tcfg, kv_quant="fp8")


# -- lane parity -------------------------------------------------------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_engine_equals_jax_and_the_sequential_lane(models, kv_quant,
                                                         overlap):
    specs = _specs(0)
    ck = dict(kv_quant=kv_quant)
    ref, _ = _ref(models, specs, cache_kw=ck, stagger=True)
    got, eng = _run(models, specs, cache_kw=ck, stagger=True,
                    overlap=overlap, **MIXED)
    want, jeng = _run_jax(models, specs, cache_kw=ck, stagger=True,
                          overlap=overlap, **MIXED)
    assert got == want
    assert got == ref
    assert eng.mixed_ticks > 0 and eng.mixed_prefill_tokens > 0
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert not eng._inflight and not eng._mixed_pref


def test_mixed_chunked_long_prompts_exact(models):
    specs = _specs(1, n=5, lo=30, hi=60)
    ref_packed, _ = _run(models, specs, stagger=True)
    ref_chunked, _ = _run(models, specs, stagger=True, packed=False,
                          prefill_chunk=16)
    got, eng = _run(models, specs, stagger=True, overlap=True, **MIXED)
    assert got == ref_packed == ref_chunked
    assert eng.mixed_ticks >= 3       # 30-60 tokens over a 16-token budget


def test_mixed_prefix_cache_exact_and_hits(models):
    rng = np.random.RandomState(3)
    pref = rng.randint(1, 128, (32,))
    specs = [(rng.randint(1, 128, (10,)), 6),
             (np.concatenate([pref, rng.randint(1, 128, (5,))]), 5),
             (np.concatenate([pref, rng.randint(1, 128, (9,))]), 5),
             (np.concatenate([pref, rng.randint(1, 128, (3,))]), 4)]
    ref, _ = _run(models, specs, stagger=True, enable_prefix_caching=True)
    got, eng = _run(models, specs, stagger=True, enable_prefix_caching=True,
                    overlap=True, **MIXED)
    want, jeng = _run_jax(models, specs, stagger=True,
                          enable_prefix_caching=True, overlap=True, **MIXED)
    assert got == ref == want
    assert eng.cache.prefix_hits == jeng.cache.prefix_hits > 0
    assert eng.mixed_ticks == jeng.mixed_ticks


@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_preemption_exact(models, overlap):
    """JAX's case at ``host_pages=0``: pool pressure mid-service preempts
    recompute-style, and the resumes re-admit through the mixed lane."""
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, 128, (20,)), 60) for _ in range(3)]
    ck = dict(num_pages=11)
    ref, er = _ref(models, specs, cache_kw=ck)
    assert er.preemptions > 0, "the fixture must force preemption"
    got, eng = _run(models, specs, cache_kw=ck, overlap=overlap, **MIXED)
    assert got == ref
    assert eng.preemptions > 0 and eng.resumes_recompute > 0


# -- dispatch, sync and budget accounting -------------------------------------
def _counting(obj, name):
    calls = {"n": 0}
    inner = getattr(obj, name)

    def counting(*a, **kw):
        calls["n"] += 1
        return inner(*a, **kw)

    setattr(obj, name, counting)
    return calls


@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_one_call_per_tick_no_prefill_no_page_write(models, overlap):
    _, tcfg, _, tparams = models
    specs = _specs(9, n=6, lo=10, hi=40, new_lo=8, new_hi=20)
    cache = tpd.PagedKVCache(tcfg, device="cpu", **CACHE)
    eng = ContinuousBatchingEngine(tcfg, tparams, cache,
                                   metrics_registry=False, overlap=overlap,
                                   **MIXED)
    calls = _counting(eng, "_step_mixed")
    for p, n in specs[:2]:
        eng.submit(p, max_new_tokens=n)
    eng.step()                     # the cold wave goes sequential
    pf0, sc0, steps0 = (eng.prefill_calls, cache.scatter_dispatches,
                        eng.decode_steps)
    writes = _counting(cache, "write_pages_batch")
    for p, n in specs[2:]:
        eng.submit(p, max_new_tokens=n)
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
    assert eng.mixed_ticks > 0 and calls["n"] == eng.mixed_ticks
    assert eng.prefill_calls == pf0 and writes["n"] == 0
    assert cache.scatter_dispatches == sc0
    # every tick ran exactly one decode dispatch: decode never paused
    assert eng.decode_steps - steps0 == ticks
    cache.audit()


def test_mixed_budget_accounting(models):
    _, tcfg, _, tparams = models
    specs = _specs(11, n=6, lo=20, hi=60, new_lo=10, new_hi=25)
    cache = tpd.PagedKVCache(tcfg, device="cpu",
                             **dict(CACHE, num_pages=96))
    eng = ContinuousBatchingEngine(tcfg, tparams, cache,
                                   metrics_registry=False, mixed=True,
                                   mixed_token_budget=20, overlap=True)
    assert eng.mixed_token_budget == 32         # rounded up to pages
    # 4 x the larger of the budget and the 64-token prefill bucket
    assert eng.mixed_ctx_cap == 256
    per_tick = []
    inner = eng._mixed_plan

    def spy():
        plan = inner()
        per_tick.append(sum(take for _, _, take, _ in plan))
        return plan

    eng._mixed_plan = spy
    for p, n in specs[:2]:
        eng.submit(p, max_new_tokens=n)
    eng.step()
    carved = []
    for p, n in specs[2:]:
        eng.submit(p, max_new_tokens=n)
        carved.append(len(p))
    eng.run_to_completion(max_steps=100_000)
    assert per_tick and max(per_tick) <= eng.mixed_token_budget
    assert sum(per_tick) == eng.mixed_prefill_tokens == sum(carved)
    cache.audit()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
def test_one_fetch_per_dispatch_on_both_lanes(models, mixed, overlap):
    """Every blocking sync goes through ``_fetch``, once a dispatch: the
    mixed tick's first tokens ride the decode outputs' fetch, so the mixed
    lane adds no fetch to the lane it runs on."""
    _, tcfg, _, tparams = models
    specs = _specs(13, n=6, lo=8, hi=30, new_lo=6, new_hi=14)
    cache = tpd.PagedKVCache(tcfg, device="cpu", **CACHE)
    kw = MIXED if mixed else {}
    eng = ContinuousBatchingEngine(tcfg, tparams, cache,
                                   metrics_registry=False, overlap=overlap,
                                   **kw)
    fetches = _counting(eng, "_fetch")
    got = _serve(eng, specs, stagger=True)
    assert len(got) == len(specs)
    assert (eng.mixed_ticks > 0) == mixed
    assert eng.host_syncs == fetches["n"] == eng.decode_steps
    assert not eng._inflight
    cache.audit()


# -- degradations -------------------------------------------------------------
def test_mixed_budget_zero_degrades_to_sequential(models):
    specs = _specs(15)
    ref, er = _run(models, specs)
    got, eng = _run(models, specs, mixed=True, mixed_token_budget=0)
    assert got == ref
    assert eng.mixed_ticks == 0 and eng._step_mixed is None
    assert eng.prefill_calls == er.prefill_calls


def test_mixed_ctx_cap_degrades_wave_shape(models):
    rng = np.random.RandomState(17)
    specs = [(rng.randint(1, 128, (10,)), 12),
             (rng.randint(1, 128, (8,)), 12),
             (rng.randint(1, 128, (60,)), 5),        # > the cap
             (rng.randint(1, 128, (12,)), 6)]
    ref, _ = _run(models, specs, stagger=True)
    got, eng = _run(models, specs, stagger=True, mixed_ctx_cap=32,
                    overlap=True, **MIXED)
    assert got == ref
    assert eng.mixed_degraded >= 1 and eng.mixed_ticks > 0


def test_mixed_idle_engine_admits_sequentially(models):
    got, eng = _run(models, _specs(19, n=3), **MIXED)
    assert eng.prefill_calls >= 1 and eng.mixed_ticks == 0


@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_first_token_eos_finishes_with_one_token(models, overlap):
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(21)
    filler = rng.randint(1, 128, (6,))
    probe = rng.randint(1, 128, (9,))
    ref, _ = _ref(models, [(filler, 20), (probe, 8)], stagger=True)
    eos = ref[1][0]

    def run(**kw):
        cache = tpd.PagedKVCache(tcfg, device="cpu",
                                 **dict(CACHE, batch=2))
        eng = ContinuousBatchingEngine(tcfg, tparams, cache, eos_id=int(eos),
                                       metrics_registry=False, **kw)
        eng.submit(filler, max_new_tokens=20)
        eng.step()
        eng.submit(probe, max_new_tokens=8)
        done = eng.run_to_completion(max_steps=100_000)
        cache.audit()
        return {r.rid: list(r.generated) for r in done}, eng

    if "eos_seq" not in _REF:
        _REF["eos_seq"] = run()
    seq = _REF["eos_seq"][0]
    mix, eng = run(overlap=overlap, **MIXED)
    assert mix == seq and mix[1] == [eos]
    assert eng.mixed_ticks > 0


# -- faults, cancel, deadline, restart ----------------------------------------
@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_step_fault_quarantines_cleanly(models, overlap):
    _, tcfg, _, tparams = models
    specs = _specs(23, n=5, lo=12, hi=40, new_lo=15, new_hi=30)
    specs[2] = (np.random.RandomState(23).randint(1, 128, (60,)), 20)
    cache = tpd.PagedKVCache(tcfg, device="cpu", **CACHE)
    eng = ContinuousBatchingEngine(tcfg, tparams, cache,
                                   metrics_registry=False, overlap=overlap,
                                   **MIXED)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in specs[:2]]
    eng.step()                                   # the cold wave
    rids += [eng.submit(p, max_new_tokens=n) for p, n in specs[2:]]
    eng.step()                  # parks the 60-token prompt, a first tick
    assert eng._mixed_pref, "the fixture must park a row"
    parked = [e["req"].rid for e in eng._mixed_pref.values()]
    decoding = [r.rid for r in eng._active.values()]
    ticks = eng.mixed_ticks
    with tfaults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("injected mixed fault"),
                  nth=1)
        eng.step()
        assert fp.fired["step_dispatch"] == 1
    assert eng.step_faults == 1 and eng.mixed_ticks == ticks
    assert not eng._mixed_pref and not eng._inflight
    done = {r.rid: r for r in eng.run_to_completion(max_steps=100_000)}
    assert sorted(done) == sorted(rids)          # nobody vanished
    for rid in parked + decoding:
        assert done[rid].status == "error"
        assert "injected mixed fault" in done[rid].error
    assert eng.requests_faulted == len(parked) + len(decoding)
    assert any(r.status == "ok" for r in done.values())
    cache.audit()
    assert cache.free_pages() == cache.num_pages - 1
    assert len(eng._free_slots) == eng.B


def test_mixed_cancel_and_deadline_mid_prefill(models):
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(25)
    cache = tpd.PagedKVCache(tcfg, device="cpu", **CACHE)
    eng = ContinuousBatchingEngine(tcfg, tparams, cache,
                                   metrics_registry=False, overlap=True,
                                   **MIXED)
    now = [100.0]
    eng._now = lambda: now[0]
    r0 = eng.submit(rng.randint(1, 128, (8,)), max_new_tokens=30)
    eng.step()
    r1 = eng.submit(rng.randint(1, 128, (60,)), max_new_tokens=5)
    r2 = eng.submit(rng.randint(1, 128, (60,)), max_new_tokens=5,
                    deadline_s=1.0)
    eng.step()
    eng.step()
    assert eng._mixed_pref, "the fixture must park mixed rows"
    assert eng.queued_tokens() > 0
    assert eng.queued_by_class()["normal"] == len(eng._mixed_pref)
    assert eng.cancel(r1) is True
    now[0] += 5.0                                # r2's deadline passes
    done = {r.rid: r for r in eng.run_to_completion(max_steps=100_000)}
    assert done[r1].status == "cancelled"
    assert done[r2].status == "expired"
    assert done[r0].status == "ok"
    cache.audit()
    assert cache.free_pages() == cache.num_pages - 1


def test_mixed_supervisor_restart_fails_parked_rows_loudly(models):
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(27)
    specs = [(rng.randint(1, 128, (10,)), 25),
             (rng.randint(1, 128, (50,)), 5),
             (rng.randint(1, 128, (50,)), 5)]

    def factory():
        c = tpd.PagedKVCache(tcfg, device="cpu", **dict(CACHE, batch=2))
        return ContinuousBatchingEngine(
            tcfg, tparams, c, metrics_registry=False,
            quarantine_faults=False, **MIXED)

    sup = EngineSupervisor(factory, backoff_s=0)
    rids = [sup.submit(specs[0][0], max_new_tokens=specs[0][1])]
    sup.step()                   # the cold wave admits the first request
    rids += [sup.submit(p, max_new_tokens=n) for p, n in specs[1:]]
    sup.step()                   # carve + the first mixed tick
    parked = [e["req"].rid for e in sup.engine._mixed_pref.values()]
    assert parked, "the fixture must park a mixed row"
    with tfaults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("mixed death"), nth=1)
        sup.step()               # dies -> restart
    done = {r.rid: r for r in sup.run_to_completion(max_steps=100_000)}
    assert sup.restarts == 1
    assert sorted(done) == sorted(rids)
    for rid in parked:
        assert done[rid].status == "error"
        assert "mixed death" in done[rid].error
    sup.engine.cache.audit()


@pytest.mark.parametrize("overlap", [False, True])
def test_mixed_parked_row_is_preemptible(models, overlap):
    """A carve claims the pool's last pages while an active row is two
    tokens from a page boundary: the parked row is the victim (released,
    requeued, recomputed) and the tokens stay the sequential lane's."""
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(31)
    a = (rng.randint(1, 128, (30,)), 40)
    b = (rng.randint(1, 128, (45,)), 4)

    def run(**kw):
        cache = tpd.PagedKVCache(tcfg, device="cpu",
                                 **dict(CACHE, num_pages=6, batch=2))
        eng = ContinuousBatchingEngine(tcfg, tparams, cache,
                                       metrics_registry=False, **kw)
        eng.submit(a[0], max_new_tokens=a[1])
        eng.step()
        eng.submit(b[0], max_new_tokens=b[1])
        done = eng.run_to_completion(max_steps=100_000)
        cache.audit()
        assert cache.free_pages() == cache.num_pages - 1
        return {r.rid: list(r.generated) for r in done}, eng

    if "parked_seq" not in _REF:
        _REF["parked_seq"] = run()
    ref = _REF["parked_seq"][0]
    got, eng = run(overlap=overlap, **MIXED)
    assert got == ref
    assert eng.preemptions >= 1
    assert all(len(got[rid]) for rid in got)


# -- the registry and the HTTP front ------------------------------------------
def test_mixed_metrics_surface_equals_jax(models):
    specs = _specs(29, n=5, lo=10, hi=40, new_lo=8, new_hi=16)
    snaps = []
    for run, obs in ((_run, tobs), (_run_jax, jobs)):
        reg = obs.MetricsRegistry()
        _, eng = run(models, specs, stagger=True, overlap=True,
                     metrics_registry=reg, **MIXED)
        snap = reg.snapshot()
        assert eng.mixed_ticks > 0
        assert snap["paddle_tpu_engine_mixed_ticks_total"]["value"] == \
            eng.mixed_ticks
        assert snap["paddle_tpu_engine_mixed_piggybacked_prefill_tokens"
                    "_total"]["value"] == eng.mixed_prefill_tokens
        hist = snap["paddle_tpu_engine_mixed_budget_tokens"]
        assert hist["count"] == eng.mixed_ticks
        assert hist["sum"] == eng.mixed_prefill_tokens
        snaps.append(snap)
    for name in ("paddle_tpu_engine_mixed_ticks_total",
                 "paddle_tpu_engine_mixed_piggybacked_prefill_tokens_total",
                 "paddle_tpu_engine_decode_steps_total",
                 "paddle_tpu_engine_prefill_padded_tokens_total"):
        assert snaps[0][name]["value"] == snaps[1][name]["value"], name
    for key in ("count", "sum", "buckets"):
        assert snaps[0]["paddle_tpu_engine_mixed_budget_tokens"][key] == \
            snaps[1]["paddle_tpu_engine_mixed_budget_tokens"][key]


@pytest.mark.parametrize("registry", [None, False])
def test_http_front_serves_the_mixed_lane(models, registry):
    """``GenerationServer(mixed=True)``: the sequential lane's tokens over
    HTTP, and ``/health`` (registry view or engine attributes) and
    ``/metrics`` carrying the mixed counters with JAX's utilization
    formula."""
    _, tcfg, _, tparams = models
    specs = _specs(33, n=4, lo=10, hi=40, new_lo=12, new_hi=20)
    want, _ = _ref(models, specs, stagger=True)
    srv = GenerationServer(tcfg, tparams,
                           tpd.PagedKVCache(tcfg, device="cpu", **CACHE),
                           overlap=True, metrics_registry=registry, **MIXED)
    eng = srv.engine
    eng.submit(specs[0][0], max_new_tokens=specs[0][1])
    eng.submit(specs[1][0], max_new_tokens=specs[1][1])
    eng.step()               # a resident batch before the HTTP requests
    # the drive loop holds until both HTTP requests are queued, so they
    # arrive while the resident batch decodes (else the batch may finish
    # first and an idle engine admits them sequentially)
    gate = threading.Event()
    has_work = eng.has_work
    eng.has_work = lambda: gate.is_set() and has_work()
    url = f"http://127.0.0.1:{srv.start()}"
    got = [None, None]

    def client(i, p, n):
        got[i] = generate_http(url, [int(t) for t in p], n)

    clients = [threading.Thread(target=client, args=(i, p, n))
               for i, (p, n) in enumerate(specs[2:])]
    try:
        for t in clients:
            t.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with srv._lock:
                if len(eng._queue) == 2:
                    break
            time.sleep(0.005)
        gate.set()
        for t in clients:
            t.join(timeout=120.0)
        code, body, _ = _get(url + "/health")
        doc = json.loads(body)
        code_m, text, _ = _get(url + "/metrics")
    finally:
        srv.stop()
    assert got == [want[2], want[3]]
    assert code == 200 and code_m == 200
    assert doc["mixed_ticks"] == eng.mixed_ticks > 0
    assert doc["mixed_prefill_tokens"] == eng.mixed_prefill_tokens
    assert doc["mixed_budget_utilization"] == round(
        eng.mixed_prefill_tokens
        / (eng.mixed_ticks * eng.mixed_token_budget), 4)
    assert 0 < doc["mixed_budget_utilization"] <= 1
    if registry is None:
        text = text.decode()
        assert (f"paddle_tpu_engine_mixed_ticks_total "
                f"{eng.mixed_ticks}\n") in text
    assert eng.cache.audit()["owned"] == 0
