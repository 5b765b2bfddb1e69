"""The port's prefix cache held against paddle_tpu: the page allocator's
prefix index (device tier), the packed prefill's history form and the
engine's prefix-caching lanes.

Both frameworks get the same fp32 weights (``params_from_jax``) at the
2-layer size of ``tests/test_torch_serving_slice.py`` and the same
numpy-made prompts.  The allocator is host bookkeeping: the same calls on
both caches must leave the same tables, refs, free list, index and
``prefix_hits``, exactly.  Hidden states and K/V of the history body
within 1e-4 (fp32 through two layers, summed in another order).  Engine
tokens equal to JAX's engine's and to the port's own solo runs, token for
token, and ``audit()`` clean after every engine test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from test_torch_serving_slice import (  # noqa: E402,F401
    PAGE, TOL, _jax_packed, _pack, models)

VOCAB = 128


def _caches(jcfg, tcfg, num_pages=8, pages_max=6, batch=1, kv_quant=None):
    jc = jpd.PagedKVCache(jcfg, num_pages=num_pages, pages_max=pages_max,
                          batch=batch, page=PAGE, kv_quant=kv_quant)
    tc = tpd.PagedKVCache(tcfg, num_pages=num_pages, pages_max=pages_max,
                          batch=batch, page=PAGE, kv_quant=kv_quant,
                          device="cpu")
    return jc, tc


def _same_state(jc, tc):
    """The allocator's whole host state, equal in both frameworks."""
    np.testing.assert_array_equal(tc.tables, jc.tables)
    np.testing.assert_array_equal(tc.lens, jc.lens)
    np.testing.assert_array_equal(tc.refs, jc.refs)
    assert tc._free == jc._free
    assert tc._owned == [list(r) for r in jc._owned]
    assert list(tc._prefix_index.items()) == list(jc._prefix_index.items())
    assert tc._prefix_parent == jc._prefix_parent
    assert tc._prefix_children == jc._prefix_children
    assert tc.prefix_hits == jc.prefix_hits
    assert tc.available_pages() == jc.available_pages()


# -- the allocator -------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_chain_keys_match_jax(dtype):
    rng = np.random.default_rng(0)
    for L in (0, 1, 15, 16, 17, 47, 48, 100):
        ctx = rng.integers(0, VOCAB, L).astype(dtype)
        keys = tpd.PagedKVCache._chain_keys(ctx, PAGE)
        assert keys == jpd.PagedKVCache._chain_keys(ctx, PAGE)
        assert len(keys) == L // PAGE
    # a key names its whole prefix: the same page after another prefix
    # hashes differently, and a shared prefix shares its keys
    a = np.arange(48, dtype=dtype)
    b = np.concatenate([a[16:32], a[:16], a[32:]])
    ka, kb = (tpd.PagedKVCache._chain_keys(x, PAGE) for x in (a, b))
    assert ka[2] != kb[2] and len(set(ka) & set(kb)) == 0
    c = np.concatenate([a[:32], a[:16]])
    assert tpd.PagedKVCache._chain_keys(c, PAGE)[:2] == ka[:2]


def test_leaf_first_eviction_keeps_chain_lookupable(models):
    """JAX's ``test_prefix_cache_evicts_leaf_first_keeps_chain_lookupable``
    on both caches: one eviction takes the chain's leaf, and a
    re-admission still reuses the two surviving pages."""
    jcfg, tcfg, _, _ = models
    jc, tc = _caches(jcfg, tcfg)
    ctx = np.arange(1, 49, dtype=np.int64)           # 3 full pages
    for c in (jc, tc):
        c.alloc_row(0, 48)
        c.register_prefix(0, ctx)
        c.release_row(0)
    assert len(tc._prefix_index) == 3 and tc.free_pages() == 4
    assert tc.available_pages() == 7
    _same_state(jc, tc)
    for c in (jc, tc):
        c.alloc_row(0, 5 * PAGE)                     # one eviction
    assert len(tc._prefix_index) == 2
    keys = tpd.PagedKVCache._chain_keys(ctx, PAGE)
    assert list(tc._prefix_index) == keys[:2]        # the leaf went
    for c in (jc, tc):
        c.release_row(0)
    assert tc.alloc_row_prefix(0, ctx) == 32
    assert jc.alloc_row_prefix(0, ctx) == 32
    _same_state(jc, tc)
    assert tc.audit() == {"free": 4, "owned": 3, "indexed": 2}


def test_aligned_whole_context_keeps_its_last_page_private(models):
    """A cached, page-aligned context shares all pages but its last,
    whose K/V the engine computes for the next-token logits; a rollback
    on exhaustion counts no hit and leaves the row empty."""
    jcfg, tcfg, _, _ = models
    jc, tc = _caches(jcfg, tcfg, num_pages=6, batch=2)
    ctx = np.arange(2, 50, dtype=np.int64)           # 3 full pages
    for c in (jc, tc):
        c.alloc_row(0, 48)
        c.register_prefix(0, ctx)
        assert c.alloc_row_prefix(1, ctx) == 32
    _same_state(jc, tc)
    assert tc.prefix_hits == 2
    assert tc.tables[1, 2] != tc.tables[0, 2]
    assert tc.audit()["owned"] == 6
    # a 5-page context sharing 2 pages needs 3 fresh of the 1 left
    longer = np.concatenate([ctx[:32], np.arange(48) + 60])
    for c in (jc, tc):
        with pytest.raises(RuntimeError, match="exhausted"):
            c.alloc_row_prefix(1, longer)
    _same_state(jc, tc)
    assert tc.prefix_hits == 2 and tc.lens[1] == 0 and not tc._owned[1]
    tc.audit()


def test_allocator_fuzz_matches_jax_and_audits_clean(models):
    """A randomized run of alloc_row / alloc_row_prefix / register_prefix
    / release_row / ensure_capacity_batch over a small pool (exhaustion,
    eviction and rollback all happen): the same calls on both caches give
    the same outcome and state, and ``audit()`` passes after every one."""
    jcfg, tcfg, _, _ = models
    rng = np.random.default_rng(7)
    jc, tc = _caches(jcfg, tcfg, num_pages=14, pages_max=6, batch=4)
    bases = [rng.integers(0, VOCAB, 96) for _ in range(3)]
    ctxs = {}
    outcomes = {"ok": 0, "exhausted": 0}
    indexed = []
    for _ in range(400):
        op = rng.integers(0, 5)
        b = int(rng.integers(0, 4))
        if op in (0, 1):
            base = bases[int(rng.integers(0, 3))]
            L = int(rng.integers(1, 6 * PAGE + 1))
            ctx = np.concatenate([base[:min(L, 96)],
                                  rng.integers(0, VOCAB, max(L - 96, 0))])
            if rng.random() < 0.3:               # diverge mid-prefix
                ctx[int(rng.integers(0, L))] = VOCAB
            ctxs[b] = ctx
            call = ((lambda c: c.alloc_row(b, len(ctx))) if op == 0
                    else (lambda c: c.alloc_row_prefix(b, ctx)))
        elif op == 2:
            if b not in ctxs or tc.lens[b] != len(ctxs[b]):
                continue
            call = (lambda c: c.register_prefix(b, ctxs[b]))
        elif op == 3:
            call = (lambda c: c.release_row(b))
        else:
            if tc.lens[b] == 0:
                continue
            n = int(rng.integers(1, 20))
            if (int(tc.lens[b]) + n - 1) // PAGE + 1 > 6:
                continue
            call = (lambda c: c.ensure_capacity_batch([(b, n)]))
        res = []
        for c in (jc, tc):
            try:
                res.append(("ok", call(c)))
            except RuntimeError:
                res.append(("exhausted", None))
        assert res[0] == res[1]
        outcomes[res[1][0]] += 1
        if op == 4 and res[1][0] == "ok":
            for c in (jc, tc):
                c.lens[b] += n
        _same_state(jc, tc)
        indexed.append(tc.audit()["indexed"])
    assert outcomes["exhausted"] > 0 and tc.prefix_hits > 0
    # the index filled and was evicted from
    assert max(indexed) >= 3 and any(
        b < a for a, b in zip(indexed, indexed[1:]))


def test_audit_catches_broken_invariants(models):
    _, tcfg, _, _ = models
    tc = tpd.PagedKVCache(tcfg, num_pages=8, pages_max=6, batch=2,
                          page=PAGE, device="cpu")
    ctx = np.arange(32, dtype=np.int64)
    tc.alloc_row(0, 32)
    tc.register_prefix(0, ctx)
    tc.alloc_row_prefix(1, np.concatenate([ctx, [1, 2]]))
    assert tc.audit() == {"free": 4, "owned": 5, "indexed": 2}
    pid = tc._owned[0][0]
    tc.refs[pid] += 1
    with pytest.raises(AssertionError, match="refs"):
        tc.audit()
    tc.refs[pid] -= 1
    key = next(iter(tc._prefix_index))
    tc._prefix_children[key].clear()               # lose the chain edge
    with pytest.raises(AssertionError, match="chain edge"):
        tc.audit()


# -- the packed prefill's history form ------------------------------------------
def _hist_stream(prefix, tail1, tail2, tail3, p0_pages):
    """Two segments over a prefix of two pool pages (``p0_pages``): seg 0
    = prefix + tail1 (one full page) + tail2; seg 1 = prefix + tail1 + tail3, taking the prefix from the pool and
    tail1's page from seg 0 in the stream."""
    seg0 = np.concatenate([prefix, tail1, tail2])
    seg1 = np.concatenate([prefix, tail1, tail3])
    start0, start1 = 32, 48
    Wp0 = -(-(len(seg0) - start0) // PAGE) * PAGE
    W0 = start0 + Wp0
    Tb = 128
    toks = np.zeros((1, Tb), np.int32)
    seg = np.full((1, Tb), 2, np.int32)
    pos = np.zeros((1, Tb), np.int32)
    hp = np.zeros(Tb, np.int32)
    hs = np.zeros(Tb, np.int32)
    ph = np.zeros(Tb, bool)
    ss = np.zeros(Tb, np.int32)
    sh = np.zeros(Tb, bool)
    seg[0, :W0] = 0
    pos[0, :W0] = np.arange(W0)
    toks[0, start0:len(seg0)] = seg0[start0:]
    W1 = start1 + PAGE
    seg[0, W0:W0 + W1] = 1
    pos[0, W0:W0 + W1] = np.arange(W1)
    toks[0, W0 + start1:W0 + len(seg1)] = seg1[start1:]
    for off in (0, W0):
        for j, pid in enumerate(p0_pages):
            a = off + j * PAGE
            hp[a:a + PAGE] = pid
            hs[a:a + PAGE] = np.arange(PAGE)
            ph[a:a + PAGE] = True
    a = W0 + 2 * PAGE                        # tail1's page, from seg 0
    ss[a:a + PAGE] = 2 * PAGE + np.arange(PAGE)
    sh[a:a + PAGE] = True
    return toks, seg, pos, (hp, hs, ph, ss, sh), (W0, start1, len(seg1))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_packed_prefill_with_history_matches_jax(models, kv_quant):
    """Pool-history slots (two cached pages, dequantized for int8 pages)
    and stream-history slots (a page the same pass writes) against JAX's
    ``_packed_prefill_body(cfg, q8, True)`` on the same pools."""
    jcfg, tcfg, jparams, tparams = models
    q8 = kv_quant == "int8"
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, VOCAB, 32)
    t1, t2, t3 = (rng.integers(0, VOCAB, n) for n in (16, 5, 7))
    jc, _ = _caches(jcfg, tcfg, num_pages=16, batch=1, kv_quant=kv_quant)
    # wave 1 caches the prefix's two pages (JAX's pass and page write)
    jc.alloc_row(0, 32)
    toks1, seg1, pos1, _ = _pack([prefix])
    _, jks, jvs = _jax_packed(jcfg, jparams, toks1, seg1, pos1, q8)
    jc.write_pages_batch([(0, jks[:, :32], jvs[:, :32], 32, 0)])
    toks, seg, pos, hist, (W0, start1, L1) = _hist_stream(
        prefix, t1, t2, t3, [int(p) for p in jc.tables[0, :2]])
    dummy = jnp.zeros((1,), jnp.float32)
    jrun = jax.jit(jpd._packed_prefill_body(jcfg, q8, True))
    jx, jk, jv = jrun(jparams, jnp.asarray(toks), jnp.asarray(seg),
                      jnp.asarray(pos), jc.kpool, jc.vpool,
                      jc.kscale if q8 else dummy,
                      jc.vscale if q8 else dummy,
                      *(jnp.asarray(a) for a in hist))
    pools = [torch.from_numpy(np.array(a)) for a in
             ((jc.kpool, jc.vpool, jc.kscale, jc.vscale) if q8
              else (jc.kpool, jc.vpool))]
    if not q8:
        pools += [None, None]
    trun = tpd._packed_prefill_body(tcfg, q8, with_hist=True)
    tx, tk, tv = trun(tparams, torch.from_numpy(toks), torch.from_numpy(seg),
                      torch.from_numpy(pos), *pools,
                      *(torch.from_numpy(a) for a in hist))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # the history slots hold the pool's (dequantized) K and seg 0's K
    ph, sh = hist[2], hist[4]
    kp = pools[0].float()
    if q8:
        kp = kp * pools[2][..., None]
    want = kp[:, torch.from_numpy(hist[0]).long(), :,
              torch.from_numpy(hist[1]).long()]          # [T, Lyr, nkv, d]
    got = tk.permute(1, 0, 2, 3)
    assert torch.equal(got[torch.from_numpy(ph)],
                       want[torch.from_numpy(ph)].to(got.dtype))
    assert torch.equal(got[torch.from_numpy(sh)],
                       got[torch.from_numpy(hist[3][sh]).long()])
    # without history the pass is the no-history body's
    tx0, _, _ = tpd._packed_prefill_body(tcfg, q8)(
        tparams, torch.from_numpy(toks), torch.from_numpy(seg),
        torch.from_numpy(pos))
    assert not torch.allclose(tx0[0, W0 + start1:W0 + L1],
                              tx[0, W0 + start1:W0 + L1], atol=1e-3)


# -- the engine -----------------------------------------------------------------
def _engines(models, kv_quant=None, batch=2, num_pages=64, pages_max=8,
             **kw):
    jcfg, tcfg, jparams, tparams = models
    jc = jpd.PagedKVCache(jcfg, num_pages=num_pages, pages_max=pages_max,
                          batch=batch, page=PAGE, kv_quant=kv_quant)
    tc = tpd.PagedKVCache(tcfg, num_pages=num_pages, pages_max=pages_max,
                          batch=batch, page=PAGE, kv_quant=kv_quant,
                          device="cpu")
    return (jse.ContinuousBatchingEngine(jcfg, jparams, jc, **kw), jc,
            ContinuousBatchingEngine(tcfg, tparams, tc, **kw), tc)


def _serve(eng, specs):
    rids = [eng.submit(p, max_new_tokens=n) for p, n in specs]
    done = {r.rid: list(r.generated) for r in eng.run_to_completion()}
    return [done[r] for r in rids]


def _solo(models, prompt, new, kv_quant=None):
    _, tcfg, _, tparams = models
    cache = tpd.PagedKVCache(tcfg, num_pages=64, pages_max=8, batch=1,
                             page=PAGE, kv_quant=kv_quant, device="cpu")
    eng = ContinuousBatchingEngine(tcfg, tparams, cache)
    return _serve(eng, [(prompt, new)])[0]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_packed_prefix_cache_same_and_cross_wave_match_jax(models,
                                                           kv_quant):
    """JAX's ``test_packed_prefix_cache_suffix_prefill_token_exact``: two
    requests sharing a 3-page prefix in one wave (the second reads the
    shared pages from the stream), then a third in a later wave (from the
    pool): ``prefix_hits`` 3, then 6; one dispatch for the first wave;
    tokens equal to JAX's engine's, and in fp to the port's solo runs.
    With int8 pages the hit's history is dequantized pool K/V, so the
    reference is JAX's int8 prefix lane, not the port's lane without
    prefix."""
    rng = np.random.RandomState(3)
    prefix = rng.randint(1, 128, (48,))
    tails = [rng.randint(1, 128, (5,)), rng.randint(1, 128, (9,))]
    specs = [(np.concatenate([prefix, t]), 5) for t in tails]
    jeng, jc, teng, tc = _engines(models, kv_quant,
                                  enable_prefix_caching=True)
    got = _serve(teng, specs)
    assert tc.prefix_hits == 3 and teng.prefill_calls == 1
    assert got == _serve(jeng, specs)
    assert jc.prefix_hits == 3
    tc.audit()
    if kv_quant is None:
        for (p, n), g in zip(specs, got):
            assert g == _solo(models, p, n)
    p3 = np.concatenate([prefix, rng.randint(1, 128, (3,))])
    got3 = _serve(teng, [(p3, 4)])
    assert tc.prefix_hits == 6
    assert got3 == _serve(jeng, [(p3, 4)])
    if kv_quant is None:
        assert got3[0] == _solo(models, p3, 4)
    # every request retired: the index alone holds the 3 prefix pages
    assert tc.audit() == {"free": 64 - 1 - 3, "owned": 0, "indexed": 3}
    assert tc.free_pages() == jc.free_pages()


def test_prefix_cache_eviction_under_pressure_matches_jax(models):
    """JAX's ``test_engine_prefix_cache_evicts_under_pressure``: 8 usable
    pages, a cached 3-page prefix, then an unrelated request that grows
    to 7 pages: eviction makes room, the tokens are JAX's."""
    rng = np.random.RandomState(15)
    p1 = rng.randint(1, 128, (50,))
    p2 = rng.randint(1, 128, (70,))
    jeng, jc, teng, tc = _engines(models, batch=1, num_pages=9,
                                  pages_max=8, enable_prefix_caching=True)
    assert _serve(teng, [(p1, 3)]) == _serve(jeng, [(p1, 3)])
    assert len(tc._prefix_index) == 3
    got = _serve(teng, [(p2, 30)])
    assert len(got[0]) == 30 and got == _serve(jeng, [(p2, 30)])
    assert got[0] == _solo(models, p2, 30)
    # growth past the free list took p1's chain from its leaf: its head
    # stays, beside p2's own four registered pages
    k1 = tpd.PagedKVCache._chain_keys(p1, PAGE)
    assert [k in tc._prefix_index for k in k1] == [True, False, False]
    assert len(tc._prefix_index) == 5
    assert list(tc._prefix_index.items()) == list(jc._prefix_index.items())
    tc.audit()


def test_prefix_cache_admission_gate_counts_evictable(models):
    """JAX's ``test_engine_prefix_cache_admission_gate_counts_evictable``:
    a request needing more pages than are free, but no more than free +
    evictable, is admitted (a gate on the free list alone would wait for
    ever)."""
    rng = np.random.RandomState(16)
    p1 = rng.randint(1, 128, (50,))
    p2 = rng.randint(1, 128, (90,))
    jeng, jc, teng, tc = _engines(models, batch=1, num_pages=9,
                                  pages_max=8, enable_prefix_caching=True)
    _serve(teng, [(p1, 3)])
    _serve(jeng, [(p1, 3)])
    assert len(tc._prefix_index) == 3 and tc.free_pages() == 5
    assert tc.available_pages() == 8
    teng.submit(p2, max_new_tokens=8)
    done = teng.run_to_completion(max_steps=200)
    assert len(done) == 1 and len(done[0].generated) == 8
    assert done[0].generated == _serve(jeng, [(p2, 8)])[0]
    tc.audit()
