"""The port's dense and chunked admission lanes held against paddle_tpu: the
dense causal prefill (``_prefill``), the chunked prefill over cached pages
(``_prefill_chunk``, fp and int8 pages), the engine's ``packed=False``
lanes (batched and chunked, with and without prefix caching) and
``generate_paged`` (``fused`` True and False).

Both frameworks get the same fp32 weights (``params_from_jax``) at the
2-layer size of ``tests/test_torch_serving_slice.py``, and at head_dim 128
(one head) where ``_rope`` takes the fused RoPE kernel's route (its plain
version on the CPU).  Hidden states, K/V and pages within 1e-4 (fp32
through two layers, summed in another order); engine and generation tokens
equal to JAX's, token for token, and within the port lane equal to lane;
``audit()`` clean after every engine test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.ops import rope as trope  # noqa: E402
from test_torch_serving_slice import (  # noqa: E402,F401
    PAGE, TOL, models)

# head_dim 128 with one head: _rope takes fused_rope (JAX: d % 128 == 0)
D128_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=1,
               num_key_value_heads=1)


@pytest.fixture(scope="module")
def models_d128():
    jcfg = jlp.LlamaPretrainConfig(**D128_KW, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**D128_KW, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(5), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture
def rope_calls(monkeypatch):
    """Counts the fused RoPE wrapper's plain-version calls."""
    calls = []
    real = trope._composite

    def spy(x, cos, sin, neg_sin):
        calls.append(tuple(x.shape))
        return real(x, cos, sin, neg_sin)

    monkeypatch.setattr(trope, "_composite", spy)
    return calls


# -- the dense prefill ---------------------------------------------------------
@pytest.mark.parametrize("which", ["gqa", "d128"])
def test_dense_prefill_matches_jax(models, models_d128, rope_calls, which):
    jcfg, tcfg, jparams, tparams = models if which == "gqa" else models_d128
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 128, (4, 24))
    jx, jks, jvs = jpd._prefill(jcfg)(jparams,
                                      jnp.asarray(prompt, jnp.int32))
    tx, tks, tvs = tpd._prefill(tcfg)(tparams, torch.from_numpy(prompt))
    assert tks.shape == (2, 4, 24, tcfg.num_key_value_heads, tcfg.head_dim)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), **TOL)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **TOL)
    # q and k of each layer through fused_rope's plain version at d 128;
    # the inline rotate-half below
    L = tcfg.num_hidden_layers
    want = 2 * L if which == "d128" else 0
    assert len(rope_calls) == want


# -- the chunked prefill -------------------------------------------------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("ctx_len", [0, 32, 40])
def test_chunked_prefill_matches_jax(models, kv_quant, ctx_len):
    """One chunk of 16 tokens over a row whose first ``ctx_len`` slots are
    cached (written by JAX's dense prefill; with int8 pages dequantized by
    the gather) against JAX's ``_prefill_chunk`` on the same pools."""
    jcfg, tcfg, jparams, tparams = models
    q8 = kv_quant == "int8"
    rng = np.random.default_rng(2)
    ctx = rng.integers(0, 128, (1, 48))
    jc = jpd.PagedKVCache(jcfg, num_pages=16, pages_max=5, batch=1,
                          page=PAGE, kv_quant=kv_quant)
    jc.alloc_row(0, 48)
    _, jks, jvs = jpd._prefill(jcfg)(jparams, jnp.asarray(ctx, jnp.int32))
    jc.write_pages_batch([(0, jks[:, 0], jvs[:, 0], 48, 0)])
    jc.ensure_capacity(0, 16)
    chunk = rng.integers(0, 128, (1, 16))
    dummy = jnp.zeros((1,), jnp.float32)
    table = jc.tables[0].copy()
    jx, jk, jv = jpd._prefill_chunk(jcfg, q8)(
        jparams, jnp.asarray(chunk, jnp.int32), jc.kpool, jc.vpool,
        jc.kscale if q8 else dummy, jc.vscale if q8 else dummy,
        jnp.asarray(table), np.int32(ctx_len))
    pools = [torch.from_numpy(np.array(a)) for a in (jc.kpool, jc.vpool)]
    pools += ([torch.from_numpy(np.array(a)) for a in (jc.kscale, jc.vscale)]
              if q8 else [None, None])
    tx, tk, tv = tpd._prefill_chunk(tcfg, q8)(
        tparams, torch.from_numpy(chunk), *pools, torch.from_numpy(table),
        ctx_len)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# -- the engine's packed=False lanes -------------------------------------------
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


def _serve(eng, specs, check=None):
    rids = [eng.submit(p, max_new_tokens=n) for p, n in specs]
    done = {}
    while eng.has_work():
        eng.step()
        if check is not None:
            check()
        done.update({r.rid: r for r in eng.finished()})
    return [list(done[r].generated) for r in rids], [done[r] for r in rids]


def _counters(eng):
    return (eng.prefill_calls, eng.prefill_token_slots,
            eng.prefill_padded_tokens)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_batched_lane_one_dispatch_matches_jax(models, kv_quant):
    """JAX's ``test_engine_batched_admission_one_prefill_for_k_arrivals``:
    4 same-bucket arrivals are one dense dispatch; tokens equal JAX's
    engine's and the port's packed lane's; the same counters."""
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, 128, (int(rng.randint(5, 16)),)), 5)
             for _ in range(4)]
    jeng, _, teng, tc = _engines(models, kv_quant, batch=4, packed=False)
    got, _ = _serve(teng, specs)
    assert teng.prefill_calls == 1, "4 same-bucket arrivals, one dispatch"
    assert got == _serve(jeng, specs)[0]
    _, _, packed, _ = _engines(models, kv_quant, batch=4)
    assert got == _serve(packed, specs)[0]
    assert _counters(teng) == _counters(jeng)
    assert tc.scatter_dispatches == 1
    assert tc.audit()["owned"] == 0


def test_batched_lane_buckets_and_resumes_match_jax(models):
    """Several buckets in one wave (one dispatch each), more requests than
    slots, and a pool sized for recompute preemption: tokens and counters
    equal JAX's engine's."""
    rng = np.random.RandomState(9)
    specs = [(rng.randint(1, 128, (L,)), n)
             for L, n in ((5, 9), (40, 12), (70, 8), (17, 14), (3, 10))]
    jeng, _, teng, tc = _engines(models, batch=3, num_pages=12,
                                 packed=False, prefill_bucket=32)
    got, reqs = _serve(teng, specs, check=tc.audit)
    assert got == _serve(jeng, specs)[0]
    assert _counters(teng) == _counters(jeng)
    assert teng.preemptions == jeng.preemptions
    assert tc.audit() == {"free": 11, "owned": 0, "indexed": 0}


def test_chunked_lane_long_prompt_matches_jax(models):
    """JAX's ``test_engine_chunked_prefill_long_prompt_parity``: 80 tokens
    at a 32-token chunk are three dispatches; tokens equal JAX's engine's
    and the port's packed lane's (one dispatch)."""
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, 128, (80,))
    jeng, _, teng, tc = _engines(models, num_pages=32, prefill_chunk=32,
                                 packed=False)
    teng.submit(prompt, max_new_tokens=6)
    teng.step()
    assert teng.prefill_calls == 3               # 32 + 32 + 16
    got = teng.run_to_completion()[0].generated
    assert got == _serve(jeng, [(prompt, 6)])[0][0]
    _, _, packed, _ = _engines(models, num_pages=32, prefill_chunk=32)
    assert got == _serve(packed, [(prompt, 6)])[0][0]
    assert packed.prefill_calls == 1
    assert _counters(teng) == _counters(jeng)
    tc.audit()


def test_chunked_lane_int8_pages_matches_jax(models):
    """JAX's ``test_engine_chunked_prefill_int8_cache``: the gather
    dequantizes cached int8 pages per chunk; tokens equal JAX's chunked
    int8 engine's and the port's unchunked int8 batched lane's."""
    rng = np.random.RandomState(8)
    prompt = rng.randint(1, 128, (70,))
    outs = {}
    for chunk in (None, 32):
        jeng, _, teng, tc = _engines(models, "int8", batch=1, num_pages=32,
                                     prefill_chunk=chunk, packed=False)
        outs[chunk] = _serve(teng, [(prompt, 5)])[0]
        assert outs[chunk] == _serve(jeng, [(prompt, 5)])[0]
        assert tc.audit()["owned"] == 0
    assert outs[None] == outs[32]


def test_chunked_lane_resumes_preempted_requests_matches_jax(models):
    """JAX's ``test_engine_preemption_composes_with_chunked_prefill``: 4
    usable pages, two 24-token prompts growing by 30: preemption, and the
    resume context (past the 32-token chunk) re-prefills chunk by chunk;
    tokens equal JAX's engine's and the port's solo runs."""
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, 128, (24,)) for _ in range(2)]
    specs = [(p, 30) for p in prompts]
    jeng, _, teng, tc = _engines(models, num_pages=5, pages_max=4,
                                 prefill_chunk=32, packed=False)
    got, reqs = _serve(teng, specs, check=tc.audit)
    assert any(r.preempted for r in reqs)
    assert got == _serve(jeng, specs)[0]
    assert _counters(teng) == _counters(jeng)
    for p, g in zip(prompts, got):
        _, _, solo, _ = _engines(models, batch=1)
        assert g == _serve(solo, [(p, 30)])[0][0]
    assert tc.audit() == {"free": 4, "owned": 0, "indexed": 0}


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefix_cache_on_chunked_lane_matches_jax(models, kv_quant):
    """JAX's ``test_engine_prefix_caching_shares_pages_token_exact`` with
    ``packed=False``: every admission takes the chunked lane from its
    reused offset; the second request reuses the first's 3 prefix pages,
    a later one again (``prefix_hits`` 3, then 6); the cached pages
    outlive their requests; tokens equal JAX's engine's, and in fp the
    port's solo runs."""
    rng = np.random.RandomState(14)
    prefix = rng.randint(1, 128, (48,))
    tails = [rng.randint(1, 128, (5,)), rng.randint(1, 128, (9,))]
    specs = [(np.concatenate([prefix, t]), 5) for t in tails]
    jeng, jc, teng, tc = _engines(models, kv_quant, packed=False,
                                  enable_prefix_caching=True)
    got, _ = _serve(teng, specs, check=tc.audit)
    assert tc.prefix_hits == 3
    assert got == _serve(jeng, specs)[0]
    assert tc.free_pages() == tc.num_pages - 1 - 3 == jc.free_pages()
    p3 = np.concatenate([prefix, rng.randint(1, 128, (3,))])
    got3, _ = _serve(teng, [(p3, 4)])
    assert tc.prefix_hits == 6 == jc.prefix_hits + 3
    assert got3 == _serve(jeng, [(p3, 4)])[0]
    assert _counters(teng) == _counters(jeng)
    if kv_quant is None:
        for (p, n), g in zip(specs + [(p3, 4)], got + got3):
            _, _, solo, _ = _engines(models, batch=1)
            assert g == _serve(solo, [(p, n)])[0][0]
    assert tc.audit() == {"free": 60, "owned": 0, "indexed": 3}


def test_prefix_cache_chunked_lane_with_prefill_chunk_matches_jax(models):
    """Prefix caching with a chunk smaller than the suffix: the suffix
    past the shared pages advances in several chunks; tokens equal JAX's
    engine's, and the packed prefix lane's."""
    rng = np.random.RandomState(21)
    prefix = rng.randint(1, 128, (32,))
    specs = [(np.concatenate([prefix, rng.randint(1, 128, (L,))]), 6)
             for L in (40, 55, 3)]
    jeng, _, teng, tc = _engines(models, packed=False, prefill_chunk=16,
                                 enable_prefix_caching=True)
    got, _ = _serve(teng, specs, check=tc.audit)
    assert got == _serve(jeng, specs)[0]
    assert _counters(teng) == _counters(jeng)
    assert tc.prefix_hits == 4
    _, _, packed, _ = _engines(models, enable_prefix_caching=True)
    assert got == _serve(packed, specs)[0]
    tc.audit()


# -- generate_paged ------------------------------------------------------------
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_paged_matches_jax(models, kv_quant):
    """Rows of 9, 24 and 17 tokens (right-padded to 24): JAX's
    ``generate_paged`` and the port's, ``fused`` True and False, give the
    same tokens, and the same pages of each row."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(3)
    lens = [9, 24, 17]
    prompt = np.zeros((3, 24), np.int64)
    for b, L in enumerate(lens):
        prompt[b, :L] = rng.integers(1, 128, L)
    outs = {}
    for fused in (True, False):
        jc = jpd.PagedKVCache(jcfg, num_pages=32, pages_max=4, batch=3,
                              page=PAGE, kv_quant=kv_quant)
        tc = tpd.PagedKVCache(tcfg, num_pages=32, pages_max=4, batch=3,
                              page=PAGE, kv_quant=kv_quant, device="cpu")
        for b, L in enumerate(lens):
            jc.alloc_row(b, L)
            tc.alloc_row(b, L)
        jt = np.asarray(jpd.generate_paged(jcfg, jparams,
                                           prompt.astype(np.int32), 12, jc,
                                           fused=fused))
        tt = tpd.generate_paged(tcfg, tparams, prompt, 12, tc, fused=fused)
        assert tt.shape == (3, 12) and tt.dtype == torch.int64
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tc.lens, jc.lens)
        np.testing.assert_array_equal(tc.tables, jc.tables)
        # the written slots of every row (page 0, the junk page, aside)
        for b in range(3):
            n = int(tc.lens[b])
            pages = tc.tables[b, :-(-n // PAGE)]
            for name in ("kpool", "vpool"):
                tp = getattr(tc, name)[:, pages].numpy().astype(np.float32)
                jp = np.asarray(getattr(jc, name)[:, pages]).astype(
                    np.float32)
                if kv_quant:
                    s = name[0] + "scale"
                    tp = tp * getattr(tc, s)[:, pages].numpy()[..., None]
                    jp = jp * np.asarray(getattr(jc, s)[:, pages])[..., None]
                tp = tp.transpose(0, 1, 3, 2, 4).reshape(
                    tp.shape[0], -1, tp.shape[2], tp.shape[4])[:, :n]
                jp = jp.transpose(0, 1, 3, 2, 4).reshape(
                    jp.shape[0], -1, jp.shape[2], jp.shape[4])[:, :n]
                np.testing.assert_allclose(tp, jp, **TOL)
        outs[fused] = tt
    assert torch.equal(outs[True], outs[False])


def test_generate_paged_samples_from_its_seed(models):
    """Sampling draws from a generator seeded by ``seed``: the same seed
    gives the same tokens, fused or not; tokens stay in the vocabulary."""
    _, tcfg, _, tparams = models
    prompt = np.random.default_rng(4).integers(1, 128, (2, 10))
    outs = []
    for fused, seed in ((True, 1), (False, 1), (True, 2)):
        tc = tpd.PagedKVCache(tcfg, num_pages=16, pages_max=4, batch=2,
                              page=PAGE, device="cpu")
        for b in range(2):
            tc.alloc_row(b, 10)
        outs.append(tpd.generate_paged(tcfg, tparams, prompt, 8, tc,
                                       temperature=0.9, top_k=20, seed=seed,
                                       fused=fused))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert int(outs[0].min()) >= 0 and int(outs[0].max()) < 128
