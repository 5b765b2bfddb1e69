"""The port's two-tier KV cache (``PagedKVCache(host_pages=N)``: the
``HostPagePool`` host tier, swap-out preemption, zero-prefill swap-in
resumes, prefix demotion and promotion) held against paddle_tpu's on the
CPU, at the 2-layer fp32 config of ``tests/test_kv_offload.py`` with the
same weights (``params_from_jax``) and the same numpy-seeded prompts.

Every engine case runs JAX's engine on the same requests and schedule:
tokens equal rid for rid, and ``preemptions``, ``resumes_swapped``,
``resumes_recompute``, ``prefill_tokens_avoided``, ``prefill_token_slots``,
``prefill_calls``, ``swap_out_pages``, ``swap_in_pages``, ``swap_bytes``,
``prefix_promotions`` and ``prefix_hits`` equal JAX's.  Each step audits
the cache, and a step that resumes a swapped request dispatches no prefill.
The invariants of ``tests/test_kv_offload.py``, in the port: token-exact
swap resumes on the packed, batched and chunked lanes over fp32 and int8
pages (and equal to the port's engine without a host tier), the counters
and bytes against the registry, the overlap lane, prefix demotion and
promotion, both cost-model fallbacks, the bit-exact cache-level round trip
(one restore dispatch), ``audit`` catching corruption, the allocator fuzz
with the host tier on and off (the same calls on both caches leave the same
state, host tier included), and ``mesh=`` still refused.
"""

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
from paddle_tpu_torch.models import kv_offload as tko  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
# two 16-token prompts + 20 new tokens each (3 pages a row at the peak)
# exceed the 4 usable pages: preemption is forced
TIGHT = dict(num_pages=5, pages_max=4, batch=2, page=16)
ENGINE_COUNTERS = ("preemptions", "resumes_swapped", "resumes_recompute",
                   "prefill_tokens_avoided", "prefill_token_slots",
                   "prefill_calls")
CACHE_COUNTERS = ("swap_out_pages", "swap_in_pages", "swap_bytes",
                  "prefix_promotions", "prefix_hits")
LANES = {"packed": {}, "batched": {"packed": False},
         "chunked": {"packed": False, "prefill_chunk": 32}}
SIDES = {"jax": (jse, jpd), "port": (tse, tpd)}


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
    return {"jax": (jcfg, jparams), "port": (tcfg, tparams)}


def _cache(models, side, **kw):
    cfg = models[side][0]
    if side == "port":
        return tpd.PagedKVCache(cfg, device="cpu", **kw)
    return jpd.PagedKVCache(cfg, **kw)


def _drive(eng, cache):
    """``run_to_completion`` that audits the cache every step and checks
    that no step resuming a swapped request dispatched a prefill.
    -> (finished requests by rid, zero-prefill resumes)."""
    done, zero = {}, 0
    steps = 0
    while eng.has_work():
        pre = (eng.prefill_calls, eng.prefill_token_slots,
               eng.resumes_swapped)
        eng.step()
        done.update((r.rid, r) for r in eng.finished())
        if eng.resumes_swapped > pre[2]:
            assert eng.prefill_calls == pre[0], \
                "a swapped resume dispatched a prefill"
            assert eng.prefill_token_slots == pre[1], \
                "a swapped resume took prefill token slots"
            zero += eng.resumes_swapped - pre[2]
        cache.audit()
        steps += 1
        assert steps < 500
    return done, zero


def _serve(models, side, prompts, new, cache_kw, knobs=None, **eng_kw):
    """Serve ``prompts`` on an engine of ``side`` -> (tokens in submit
    order, engine, cache, zero-prefill resumes)."""
    se = SIDES[side][0]
    cfg, params = models[side]
    cache = _cache(models, side, **cache_kw)
    eng_kw.setdefault("metrics_registry", False)
    eng = se.ContinuousBatchingEngine(cfg, params, cache, **eng_kw)
    for name, value in (knobs or {}).items():
        setattr(eng, name, value)
    rids = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, [new] * len(prompts)
                            if np.isscalar(new) else new)]
    done, zero = _drive(eng, cache)
    return [[int(t) for t in done[r].generated] for r in rids], eng, cache, \
        zero


def _clean(cache):
    cache.audit()
    assert cache.free_pages() == cache.num_pages - 1
    assert not cache._swapped
    if cache.host is not None:
        assert cache.host.used_pages() == 0


def _both(models, prompts, new, cache_kw, knobs=None, clean=True,
          **eng_kw):
    """The same requests on JAX's engine and the port's: tokens and every
    swap, resume and promotion counter equal -> (tokens, port engine, port
    cache, zero-prefill resumes)."""
    out = {side: _serve(models, side, prompts, new, cache_kw, knobs,
                        **eng_kw) for side in SIDES}
    (jt, je, jc, jz), (tt, te, tc, tz) = out["jax"], out["port"]
    assert tt == jt
    for name in ENGINE_COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    for name in CACHE_COUNTERS:
        assert getattr(tc, name) == getattr(jc, name), name
    assert tz == jz
    assert tc.audit() == jc.audit()
    if clean:
        _clean(tc)
        _clean(jc)
    return tt, te, tc, tz


def _prompts(seed, n=2, L=16):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (L,)) for _ in range(n)]


# -- the engine: swap-out preemption and zero-prefill resumes ----------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("lane", list(LANES))
def test_swap_preempt_resume_token_exact(models, kv_quant, lane):
    """Preemption swaps the victim to the host tier and restores it with
    zero prefill tokens on the three admission lanes and both page dtypes:
    tokens and counters equal JAX's, and equal the port's engine without a
    host tier (recompute resumes)."""
    prompts = _prompts(6)
    got, eng, cache, zero = _both(
        models, prompts, 20, dict(TIGHT, kv_quant=kv_quant, host_pages=16),
        **LANES[lane])
    assert eng.preemptions > 0 and eng.resumes_swapped > 0 and zero > 0
    assert eng.prefill_tokens_avoided > 0
    ref, eoff, _, _ = _serve(models, "port", prompts, 20,
                             dict(TIGHT, kv_quant=kv_quant), **LANES[lane])
    assert eoff.preemptions > 0 and eoff.resumes_swapped == 0
    assert got == ref


def test_swap_counts_and_bytes_on_the_registry(models):
    """The cache's page and byte counters agree with the registry's
    instruments (on both sides), and the resume counters split swapped
    from recompute."""
    regs = {"jax": jobs.MetricsRegistry(), "port": tobs.MetricsRegistry()}
    out = {}
    for side in SIDES:
        out[side] = _serve(models, side, _prompts(6), 20,
                           dict(TIGHT, host_pages=16),
                           metrics_registry=regs[side])
    assert out["port"][0] == out["jax"][0]
    _, eng, cache, _ = out["port"]
    assert cache.swap_out_pages > 0
    assert cache.swap_in_pages == cache.swap_out_pages
    assert cache.swap_bytes == \
        (cache.swap_out_pages + cache.swap_in_pages) * cache.page_bytes
    assert cache.page_bytes == out["jax"][2].page_bytes
    names = ["paddle_tpu_kvcache_swap_out_pages_total",
             "paddle_tpu_kvcache_swap_in_pages_total",
             "paddle_tpu_kvcache_swap_bytes_total",
             "paddle_tpu_engine_preempt_resume_swapped_total",
             "paddle_tpu_engine_preempt_resume_recompute_total",
             "paddle_tpu_engine_prefill_tokens_avoided_total",
             "paddle_tpu_kvcache_host_pool_pages",
             "paddle_tpu_kvcache_host_pool_free_pages"]
    vals = {side: [regs[side].get(n).value for n in names] for side in SIDES}
    assert vals["port"] == vals["jax"]
    assert vals["port"] == [cache.swap_out_pages, cache.swap_in_pages,
                            cache.swap_bytes, eng.resumes_swapped,
                            eng.resumes_recompute,
                            eng.prefill_tokens_avoided, 0.0, 16.0]
    assert eng.resumes_swapped > 0 and eng.prefill_tokens_avoided > 0
    hist = regs["port"].get("paddle_tpu_kvcache_swap_seconds")
    assert hist.count == eng.preemptions


def test_swap_offload_overlap_token_exact(models):
    """Offload composes with the dispatch-ahead pipeline: the overlap
    engine swaps out after its flush and serves JAX's overlap engine's
    tokens, which equal the port's synchronous lane without a host tier."""
    prompts = _prompts(7)
    got, eng, _, _ = _both(models, prompts, 20, dict(TIGHT, host_pages=16),
                           overlap=True)
    assert eng.resumes_swapped > 0 and not eng._inflight
    ref, _, _, _ = _serve(models, "port", prompts, 20, TIGHT)
    assert got == ref


def test_host_prefix_demotion_and_promotion_as_jax(models):
    """Pool pressure demotes cached-prefix leaves to the host tier instead
    of dropping them; a later admission that misses on the device but hits
    the host tier promotes the pages back (one batched restore) and reuses
    them, as in JAX, token for token."""
    rng = np.random.RandomState(15)
    p1 = rng.randint(1, 128, (50,))
    p2 = rng.randint(1, 128, (70,))
    p3 = np.concatenate([p1[:48], rng.randint(1, 128, (3,))])
    kw = dict(num_pages=9, pages_max=8, batch=1, page=16, host_pages=8)
    res = {}
    for side in SIDES:
        se = SIDES[side][0]
        cfg, params = models[side]
        cache = _cache(models, side, **kw)
        eng = se.ContinuousBatchingEngine(cfg, params, cache,
                                          enable_prefix_caching=True,
                                          metrics_registry=False)
        log = []
        for p, n in ((p1, 3), (p2, 30), (p3, 4)):
            eng.submit(p, max_new_tokens=n)
            done, _ = _drive(eng, cache)
            log.append(([int(t) for t in list(done.values())[0].generated],
                        len(cache._prefix_index),
                        len(cache._host_prefix_index), cache.swap_out_pages,
                        cache.prefix_promotions, cache.prefix_hits,
                        cache.restore_dispatches))
        res[side] = (log, cache)
    assert res["port"][0] == res["jax"][0]
    log, cache = res["port"]
    assert log[0][1] == 3                 # p1's three pages cached
    assert log[1][2] > 0 and log[1][3] > 0, "p2 should demote p1's pages"
    assert log[2][4] > log[1][4]          # p3 promoted them back
    assert log[2][5] - log[1][5] == 3     # all three prefix pages hit
    assert cache.audit() == res["jax"][1].audit()


def test_cost_model_falls_back_when_host_tier_full(models):
    """A 1-page host tier cannot hold a 2-page victim: recompute, as in
    JAX, and the tokens of the engine without a host tier."""
    prompts = _prompts(6)
    got, eng, _, _ = _both(models, prompts, 20, dict(TIGHT, host_pages=1))
    assert eng.preemptions > 0 and eng.resumes_swapped == 0
    assert eng.resumes_recompute > 0
    assert got == _serve(models, "port", prompts, 20, TIGHT)[0]


def test_cost_model_falls_back_when_recompute_cheaper(models):
    """A swap link priced absurdly slow flips the decision to recompute
    with host room to spare."""
    prompts = _prompts(6)
    got, eng, _, _ = _both(models, prompts, 20, dict(TIGHT, host_pages=16),
                           knobs={"offload_swap_gbps": 1e-9})
    assert eng.preemptions > 0 and eng.resumes_swapped == 0
    assert eng.resumes_recompute > 0
    assert got == _serve(models, "port", prompts, 20, TIGHT)[0]


def test_cost_model_prices_as_jax(models):
    """``_preempt_mode`` on the CPU reads JAX's rate (5e10 FLOP/s) and
    parameter count, so both engines decide alike at every bandwidth; on
    CUDA the rate is the H100's bf16 dense peak."""
    engs = {}
    for side in SIDES:
        se = SIDES[side][0]
        cfg, params = models[side]
        cache = _cache(models, side, **dict(TIGHT, host_pages=16))
        cache.alloc_row(0, 30)
        engs[side] = se.ContinuousBatchingEngine(cfg, params, cache,
                                                 metrics_registry=False)
    assert tse._count_params(models["port"][1]) == \
        jse._count_params(models["jax"][1])
    assert tse._chip_flops_default("cpu") == jse._chip_flops_default()
    assert tse._chip_flops_default("cuda") == 989e12
    for gbps in (1e-9, 1e-3, 1.0, 10.0, 1e9):
        modes = []
        for e in engs.values():
            e.offload_swap_gbps = gbps
            modes.append(e._preempt_mode(0))
        assert modes[0] == modes[1], gbps


# -- the cache: round trip, audit, fuzz --------------------------------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_swap_roundtrip_bitexact_at_cache_level(models, kv_quant):
    """``swap_out_row`` -> ``swap_in_row`` round-trips the pages (and int8
    scales) bit for bit through the host tier into other device pages, in
    one restore dispatch, with the pool tensors written in place."""
    cfg, params = models["port"]
    cache = tpd.PagedKVCache(cfg, num_pages=12, pages_max=8, batch=2,
                             page=16, kv_quant=kv_quant, host_pages=8,
                             device="cpu")
    ptrs = [t.data_ptr() for t in (cache.kpool, cache.vpool)]
    rng = np.random.RandomState(3)
    cache.alloc_row(0, 40)
    padded = np.zeros((1, 48), np.int64)
    padded[0, :40] = rng.randint(1, 128, (40,))
    _, ks, vs = tpd._prefill(cfg)(params, torch.from_numpy(padded))
    cache.write_row_pages(0, ks[:, 0], vs[:, 0], 40)
    cache.alloc_row(1, 20)             # another row takes fresh pages
    ids0 = [int(cache.tables[0, j]) for j in range(3)]
    snap = [t[:, ids0].clone() for t in (cache.kpool, cache.vpool,
                                         cache.kscale, cache.vscale)
            if t is not None]
    handle = cache.swap_out_row(0)
    cache.audit()
    assert cache.swap_pages_needed(handle) == 3
    assert cache.swap_ctx_len(handle) == 40
    assert cache.host.used_pages() == 3
    # the freed device pages are overwritten before the restore
    for t in (cache.kpool, cache.vpool):
        t[:, ids0] = 0
    restores = cache.restore_dispatches
    assert cache.swap_in_row(0, handle) == 40
    cache.audit()
    assert cache.restore_dispatches == restores + 1
    ids1 = [int(cache.tables[0, j]) for j in range(3)]
    got = [t[:, ids1] for t in (cache.kpool, cache.vpool, cache.kscale,
                                cache.vscale) if t is not None]
    for a, b in zip(snap, got):
        assert torch.equal(a, b)
    assert int(cache.lens[0]) == 40 and cache.host.used_pages() == 0
    assert [t.data_ptr() for t in (cache.kpool, cache.vpool)] == ptrs
    assert cache.swap_out_pages == cache.swap_in_pages == 3


def test_host_page_pool_runs_and_pending(models):
    """The host pool's allocator, its runs of consecutive pages, the
    pending batches that ``free`` drains (only those writing the page) and
    the staged-batch bound; a CPU pool is not pinned."""
    cfg = models["port"][0]
    pool = tko.HostPagePool(cfg, 4, 16, torch.float32, kv_quant="int8")
    assert not pool.kbuf.is_pinned() and pool.kscale is not None
    assert pool.nbytes == 2 * 4 * (2 * 2 * 16 * 16 * 4 + 2 * 2 * 16 * 4)
    assert tko._runs([3, 4, 5, 0, 2, 3]) == [(0, 3, 3), (3, 0, 1),
                                             (4, 2, 2)]
    hids = [pool.alloc() for _ in range(3)]
    assert hids == [0, 1, 2] and pool.used_pages() == 3
    blk = torch.randn(3, 2, 2, 16, 16)
    sc = torch.rand(3, 2, 2, 16)
    pool.stage([2, 0, 1], blk, -blk, sc, -sc)
    pool.stage([1], blk[:1] + 1, blk[:1], sc[:1], sc[:1])
    pool.free(0)
    assert len(pool._pending) == 1 and pool._pending[0][0] == [1]
    k, v, ks, vs = pool.gather([2, 1])
    assert not pool._pending
    assert torch.equal(k, torch.stack([blk[0], blk[0] + 1]))
    assert torch.equal(vs[0], -sc[0])
    for _ in range(tko._MAX_PENDING):
        pool.stage([2], blk[:1], blk[:1], sc[:1], sc[:1])
    assert not pool._pending            # the bound flushed them
    with pytest.raises(ValueError):
        tko.HostPagePool(cfg, 0, 16, torch.float32)


def test_audit_detects_corruption(models):
    """``audit`` trips on broken accounting, the host tier's included."""
    cfg = models["port"][0]
    cache = tpd.PagedKVCache(cfg, num_pages=8, pages_max=4, batch=2,
                             page=16, host_pages=4, device="cpu")
    cache.alloc_row(0, 30)
    cache.audit()
    cache.refs[int(cache.tables[0, 0])] += 1       # phantom ref
    with pytest.raises(AssertionError, match="refs"):
        cache.audit()
    cache.refs[int(cache.tables[0, 0])] -= 1
    cache.audit()
    cache._free.append(int(cache.tables[0, 1]))    # free while owned
    with pytest.raises(AssertionError):
        cache.audit()
    cache._free.pop()
    handle = cache.swap_out_row(0)
    cache.audit()
    hid = cache._swapped[handle]["entries"][0][1]
    cache.host._free.append(hid)                   # host page leaked twice
    with pytest.raises(AssertionError, match="host"):
        cache.audit()
    cache.host._free.pop()
    cache.discard_swap(handle)
    assert cache.audit() == {"free": 7, "owned": 0, "indexed": 0,
                             "swap_records": 0, "host_free": 4,
                             "host_indexed": 0}


def _host_state(c):
    """The whole allocator state, both tiers."""
    host = None
    if c.host is not None:
        host = (list(c.host._free), list(c._host_prefix_index.items()),
                {h: (r["entries"], r["lens"]) for h, r in c._swapped.items()})
    return (c.tables.tolist(), c.lens.tolist(), c.refs.tolist(),
            list(c._free), [list(r) for r in c._owned],
            list(c._prefix_index.items()), dict(c._prefix_parent),
            {k: set(v) for k, v in c._prefix_children.items()},
            c.prefix_hits, c.prefix_promotions, c.swap_out_pages,
            c.swap_in_pages, c.swap_bytes, host)


@pytest.mark.parametrize("offload", [False, True])
def test_page_accounting_fuzz_as_jax(models, offload):
    """JAX's randomized admit / prefix admit / register / retire / grow /
    swap-preempt / resume / discard churn on both caches: each call has
    the same outcome and leaves the same state (both tiers), ``audit``
    passes after every one, and the pools reconcile at the end."""
    rng = np.random.RandomState(1234 + int(offload))
    kw = dict(num_pages=12, pages_max=6, batch=3, page=16,
              host_pages=8 if offload else 0)
    caches = {side: _cache(models, side, **kw) for side in SIDES}
    shared = rng.randint(1, 128, (48,))
    busy, ctxs, handles = [False] * 3, [None] * 3, []

    def pick(want_busy):
        rows = [b for b in range(3) if busy[b] == want_busy]
        return int(rng.choice(rows)) if rows else None

    def apply(fn):
        out = {}
        for side, c in caches.items():
            try:
                out[side] = ("ok", fn(c))
            except (RuntimeError, ValueError) as e:
                out[side] = (type(e).__name__, None)
            c.audit()
        assert out["port"] == out["jax"]
        assert _host_state(caches["port"]) == _host_state(caches["jax"])
        return out["port"]

    for _ in range(300):
        op = rng.randint(0, 7)
        if op == 0 and pick(False) is not None:
            b, L = pick(False), int(rng.randint(1, 80))
            if apply(lambda c: c.alloc_row(b, L))[0] == "ok":
                busy[b], ctxs[b] = True, rng.randint(1, 128, (L,))
        elif op == 1 and pick(False) is not None:
            b = pick(False)
            ctx = np.concatenate([shared, rng.randint(
                1, 128, (int(rng.randint(1, 20)),))])
            if apply(lambda c: c.alloc_row_prefix(b, ctx))[0] == "ok":
                busy[b], ctxs[b] = True, ctx
        elif op == 2 and pick(True) is not None:
            b = pick(True)
            if ctxs[b] is not None:
                apply(lambda c: c.register_prefix(b, ctxs[b]))
        elif op == 3 and pick(True) is not None:
            b = pick(True)
            apply(lambda c: c.release_row(b))
            busy[b], ctxs[b] = False, None
        elif op == 4 and pick(True) is not None:
            b, n = pick(True), int(rng.randint(1, 20))
            apply(lambda c: c.ensure_capacity(b, new_tokens=n))
        elif op == 5 and offload and pick(True) is not None:
            b = pick(True)
            res = apply(lambda c: c.swap_out_row(b))
            if res[0] == "ok":
                handles.append(res[1])
                busy[b], ctxs[b] = False, None
        elif op == 6 and handles:
            h = handles.pop()
            if rng.randint(0, 4) == 0:
                apply(lambda c: c.discard_swap(h))
            elif pick(False) is None:
                handles.append(h)
            else:
                b = pick(False)
                if apply(lambda c: c.swap_in_row(b, h))[0] == "ok":
                    busy[b] = True
                else:
                    handles.append(h)          # the record stays
    for b in range(3):
        apply(lambda c: c.release_row(b))
    for h in handles:
        apply(lambda c: c.discard_swap(h))
    stats, jstats = caches["port"].audit(), caches["jax"].audit()
    if not offload:
        # a cache without a host tier holds no swap record, and the port's
        # audit leaves the key out there
        assert jstats.pop("swap_records") == 0
    assert stats == jstats
    assert stats["owned"] == 0
    if offload:
        assert stats["swap_records"] == 0
        assert stats["host_free"] + stats["host_indexed"] == 8
        assert caches["port"].swap_out_pages > 0


def test_mesh_still_refused(models):
    """The TP form of the cache (and so of its host tier) stays out; the
    hand-off records that once refused with it now stage through the host
    tier (``tests/test_torch_disagg.py`` holds them against JAX's)."""
    cfg = models["port"][0]
    with pytest.raises(NotImplementedError, match="item 7"):
        tpd.PagedKVCache(cfg, 8, 4, 2, page=16, mesh=object(),
                         host_pages=8, device="cpu")
    cache = tpd.PagedKVCache(cfg, 8, 4, 2, page=16, host_pages=8,
                             device="cpu")
    cache.alloc_row(0, 20)
    cache.lens[0] = 20
    state = cache.export_row(0)
    assert state["pages"] == 2 and len(state["hids"]) == 2
    assert cache.audit()["host_free"] == 6
    cache.export_discard(state)
    assert cache.audit()["host_free"] == 8
