"""The port's serving slice held against paddle_tpu on shared weights: the
packed prefill of a mixed-length wave, the per-token paged decode step under
teacher forcing, the engine's greedy outputs, recompute preemption and the
HTTP front; and the int8 serving path (weights from ``quantize_params_int8``,
pages from ``PagedKVCache(kv_quant="int8")``, each on or off).

Both frameworks get the same fp32 weights (``params_from_jax``) and the same
numpy-made inputs.  Tolerance 1e-4 on hidden states, pages and logits (fp32
through two layers, summed in another order).  Free-running greedy
sequences are not compared across the frameworks: near-ties of a tiny
random model fork them for no real reason.  Instead each served token must
be the JAX teacher-forced argmax wherever JAX's top-2 margin exceeds 1e-3,
and inside the port the batched lane must equal a solo run token for token.
With int8 pages the JAX reference is JAX's own int8 path (its packed prefill
quantized on the page write, then its ``step_q8`` teacher-forced), since the
decode attends over quantized pages.  With the trunk's kernel flags on in
both packages (set A: rms_norm + swiglu; set B: all three), the packed
prefill and the teacher-forced decode steps of a model whose hidden size
takes the rms_norm kernel (128) against JAX's with its flags on.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from paddle_tpu.flags import get_flags, set_flags  # noqa: E402
from paddle_tpu.models import decode as jdec  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu_torch import flags as tflags  # noqa: E402
from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http, generate_http_stream)
from paddle_tpu_torch.models import decode as tdec  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine, SchedulerPolicy, TenantQuotas)
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
PAGE = 16
KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
WAVE = [5, 16, 1, 33]          # prompt lengths of one admission wave


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


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, KW["vocab_size"], L) for L in lens]


def _pack(prompts, bucket=64):
    """The engine's packed stream: page-padded segments, sentinel tail,
    within-segment positions, a power-of-two number of buckets."""
    offs, T = [], 0
    for p in prompts:
        offs.append(T)
        T += -(-len(p) // PAGE) * PAGE
    n = -(-T // bucket)
    Tb = bucket * (1 << (n - 1).bit_length())
    toks = np.zeros((1, Tb), np.int32)
    seg = np.full((1, Tb), len(prompts), np.int32)
    pos = np.zeros((1, Tb), np.int32)
    for i, (p, off) in enumerate(zip(prompts, offs)):
        W = -(-len(p) // PAGE) * PAGE
        seg[0, off:off + W] = i
        pos[0, off:off + W] = np.arange(W)
        toks[0, off:off + len(p)] = p
    return toks, seg, pos, offs


def _jax_packed(jcfg, jparams, toks, seg, pos, q8=False):
    run = jax.jit(jpd._packed_prefill_body(jcfg, q8, False))
    T = toks.shape[1]
    L, nkv, d = (jcfg.num_hidden_layers, jcfg.num_key_value_heads,
                 jcfg.head_dim)
    pool = jnp.zeros((L, 2, nkv, PAGE, d), jnp.int8 if q8 else jnp.float32)
    # the q8 form threads [L, ...] scale pools through its scan
    scale = (jnp.ones((L, 2, nkv, PAGE), jnp.float32) if q8
             else jnp.zeros((1,), jnp.float32))
    zi = jnp.zeros((T,), jnp.int32)
    zb = jnp.zeros((T,), bool)
    return run(jparams, jnp.asarray(toks), jnp.asarray(seg),
               jnp.asarray(pos), pool, pool, scale, scale, zi, zi, zb, zi,
               zb)


def _jax_logits(jcfg, jparams, x):
    h = jlp._rms_norm(x, jparams["final_norm"], jcfg.rms_norm_eps)
    return np.asarray(jlp._mm(h, jparams["lm_head"], jcfg.dtype))


def _port_logits(tcfg, tparams, x):
    h = tlp._rms_norm(x, tparams["final_norm"], tcfg.rms_norm_eps)
    return tlp._mm(h, tparams["lm_head"], tcfg.dtype).numpy()


def _caches(jcfg, tcfg, prompts, kv_quant=None):
    jc = jpd.PagedKVCache(jcfg, num_pages=32, pages_max=6,
                          batch=len(prompts), page=PAGE, kv_quant=kv_quant)
    tc = tpd.PagedKVCache(tcfg, num_pages=32, pages_max=6,
                          batch=len(prompts), page=PAGE, kv_quant=kv_quant,
                          device="cpu")
    for slot, p in enumerate(prompts):
        jc.alloc_row(slot, len(p))
        tc.alloc_row(slot, len(p))
    np.testing.assert_array_equal(jc.tables, tc.tables)
    return jc, tc


def _prefill_wave(models, kv_quant=None):
    """One packed wave through both frameworks, its pages written."""
    jcfg, tcfg, jparams, tparams = models
    q8 = kv_quant == "int8"
    prompts = _prompts(WAVE)
    toks, seg, pos, offs = _pack(prompts)
    jx, jks, jvs = _jax_packed(jcfg, jparams, toks, seg, pos, q8)
    run = tpd._packed_prefill_body(tcfg, q8=q8)
    tx, tks, tvs = run(tparams, torch.from_numpy(toks),
                       torch.from_numpy(seg), torch.from_numpy(pos))
    jc, tc = _caches(jcfg, tcfg, prompts, kv_quant)
    spans = [(slot, off, -(-len(p) // PAGE) * PAGE, len(p))
             for slot, (p, off) in enumerate(zip(prompts, offs))]
    jc.write_pages_batch([(s, jks[:, o:o + W], jvs[:, o:o + W], L, 0)
                          for s, o, W, L in spans])
    tc.write_pages_batch([(s, tks[:, o:o + W], tvs[:, o:o + W], L, 0)
                          for s, o, W, L in spans])
    last = [o + L - 1 for _, o, _, L in spans]
    return dict(prompts=prompts, jx=jx, jks=jks, jvs=jvs, tx=tx, tks=tks,
                tvs=tvs, jc=jc, tc=tc, last=last)


@pytest.fixture(scope="module")
def prefilled(models):
    return _prefill_wave(models)


@pytest.fixture(scope="module")
def prefilled_q8(models):
    return _prefill_wave(models, "int8")


@pytest.fixture(scope="module")
def qparams(models):
    """int8 weights on both sides: JAX's ``quantize_params_int8``, carried
    across bit for bit (tests/test_torch_int8_matmul.py holds the port's
    own quantizer equal to it)."""
    _, _, jparams, _ = models
    jq = jdec.quantize_params_int8(jparams)
    return jq, params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                               device="cpu")


def test_packed_prefill_matches_jax(models, prefilled):
    jcfg, tcfg, jparams, tparams = models
    st = prefilled
    np.testing.assert_allclose(st["tx"].numpy(), np.asarray(st["jx"]), **TOL)
    np.testing.assert_allclose(st["tks"].numpy(), np.asarray(st["jks"]),
                               **TOL)
    np.testing.assert_allclose(st["tvs"].numpy(), np.asarray(st["jvs"]),
                               **TOL)
    # the written pages
    np.testing.assert_allclose(st["tc"].kpool.numpy(),
                               np.asarray(st["jc"].kpool), **TOL)
    np.testing.assert_allclose(st["tc"].vpool.numpy(),
                               np.asarray(st["jc"].vpool), **TOL)
    assert st["tc"].scatter_dispatches == 1
    # first-token logits from each segment's last real position
    jl = _jax_logits(jcfg, jparams, st["jx"][0, jnp.asarray(st["last"])])
    tl = _port_logits(tcfg, tparams, st["tx"][0, st["last"]])
    np.testing.assert_allclose(tl, jl, **TOL)


def _dequant(pool, scale):
    """Pages as the attention sees them: codes times their slot's scale."""
    return (np.asarray(pool).astype(np.float32)
            * np.asarray(scale)[..., None])


def _pools(cache):
    """A cache's pool tensors, scale pools included for int8 pages."""
    if cache.kv_quant == "int8":
        return cache.kpool, cache.vpool, cache.kscale, cache.vscale
    return cache.kpool, cache.vpool


def _assert_pages_match(tc, jc):
    if tc.kv_quant == "int8":
        assert tc.kpool.dtype == torch.int8
        np.testing.assert_allclose(_dequant(tc.kpool, tc.kscale),
                                   _dequant(jc.kpool, jc.kscale), **TOL)
        np.testing.assert_allclose(_dequant(tc.vpool, tc.vscale),
                                   _dequant(jc.vpool, jc.vscale), **TOL)
    else:
        np.testing.assert_allclose(tc.kpool.numpy(), np.asarray(jc.kpool),
                                   **TOL)
        np.testing.assert_allclose(tc.vpool.numpy(), np.asarray(jc.vpool),
                                   **TOL)


def _teacher_force_steps(models, st, kv_quant=None, steps=20):
    """Both frameworks' decode steps over the prefilled caches, JAX's
    tokens fed to both; logits, tokens and pages compared every step."""
    jcfg, tcfg, jparams, tparams = models
    jc, tc = st["jc"], st["tc"]
    jstep = jpd.make_paged_decode_step(jcfg, kv_quant=kv_quant,
                                       with_logits=True)
    tstep = tpd.make_paged_decode_step(tcfg, kv_quant=kv_quant,
                                       with_logits=True)
    tok = _jax_logits(jcfg, jparams,
                      st["jx"][0, jnp.asarray(st["last"])]).argmax(-1)
    key = jax.random.PRNGKey(0)
    B = len(WAVE)
    for _ in range(steps):       # the 16-token row crosses a page edge
        for b in range(B):
            jc.ensure_capacity(b)
            tc.ensure_capacity(b)
        np.testing.assert_array_equal(jc.tables, tc.tables)
        *jpools, jn, jl = jstep(
            jparams, *_pools(jc), jnp.asarray(jc.tables),
            jnp.asarray(jc.lens), jnp.asarray(tok.astype(np.int32)), key)
        if kv_quant == "int8":
            jc.kpool, jc.vpool, jc.kscale, jc.vscale = jpools
        else:
            jc.kpool, jc.vpool = jpools
        *_, tn, tl = tstep(
            tparams, *_pools(tc), torch.from_numpy(tc.tables),
            torch.from_numpy(tc.lens), torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tok = np.asarray(jn)               # JAX's tokens feed both sides
        jc.lens = jc.lens + 1
        tc.lens = tc.lens + 1
    _assert_pages_match(tc, jc)


def test_decode_step_logits_match_jax_under_teacher_forcing(models,
                                                           prefilled):
    _teacher_force_steps(models, prefilled)


def test_packed_prefill_int8_pages_match_jax(models, prefilled_q8):
    """The q8 prefill form computes what the fp form does (the stream
    attends over its own unquantized K/V); the page write quantizes per
    (layer, slot, head) into int8 codes and f32 scale planes."""
    jcfg, tcfg, jparams, tparams = models
    st = prefilled_q8
    np.testing.assert_allclose(st["tx"].numpy(), np.asarray(st["jx"]), **TOL)
    np.testing.assert_allclose(st["tks"].numpy(), np.asarray(st["jks"]),
                               **TOL)
    tc = st["tc"]
    assert tc.kscale.shape == (2, 32, KW["num_key_value_heads"], PAGE)
    assert tc.scatter_dispatches == 1
    _assert_pages_match(tc, st["jc"])
    # slots the wave did not write keep code 0 and scale 1
    unused = [p for p in range(32) if p not in set(tc.tables.ravel())]
    assert torch.equal(tc.kscale[:, unused], torch.ones_like(
        tc.kscale[:, unused]))
    assert not tc.kpool[:, unused].any()


def test_decode_step_q8_logits_match_jax_under_teacher_forcing(
        models, prefilled_q8):
    _teacher_force_steps(models, prefilled_q8, "int8")


def _engine(tcfg, tparams, batch=4, num_pages=48, pages_max=6,
            kv_quant=None, **kw):
    cache = tpd.PagedKVCache(tcfg, num_pages=num_pages, pages_max=pages_max,
                             batch=batch, page=PAGE, kv_quant=kv_quant,
                             device="cpu")
    return ContinuousBatchingEngine(tcfg, tparams, cache, **kw), cache


def _solo(tcfg, tparams, prompt, new, kv_quant=None):
    eng, _ = _engine(tcfg, tparams, kv_quant=kv_quant)
    eng.submit(prompt, max_new_tokens=new)
    (req,) = eng.run_to_completion()
    return req.generated


def test_engine_greedy_equals_solo_runs_and_jax_argmax(models):
    jcfg, tcfg, jparams, tparams = models
    prompts = _prompts([5, 16, 1, 33, 20], seed=1)
    news = [8, 6, 9, 5, 7]
    eng, cache = _engine(tcfg, tparams)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    done = {r.rid: r for r in eng.run_to_completion()}
    assert sorted(done) == rids
    assert eng.prefill_calls >= 2          # batch 4 < 5 requests
    cache.audit()
    # (a) lane == solo, token for token
    for rid, p, n in zip(rids, prompts, news):
        assert done[rid].generated == _solo(tcfg, tparams, p, n)
    # (b) JAX teacher-forced argmax where its top-2 margin is > 1e-3
    seqs = [np.concatenate([p, done[r].generated[:-1]]).astype(np.int32)
            for r, p in zip(rids, prompts)]
    toks, seg, pos, offs = _pack(seqs)
    jx, _, _ = _jax_packed(jcfg, jparams, toks, seg, pos)
    logits = _jax_logits(jcfg, jparams, jx[0])
    checked = 0
    for rid, p, off in zip(rids, prompts, offs):
        gen = done[rid].generated
        rows = logits[off + len(p) - 1:off + len(p) - 1 + len(gen)]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        for j, t in enumerate(gen):
            if top2[j, 1] - top2[j, 0] > 1e-3:
                checked += 1
                assert t == int(rows[j].argmax()), (rid, j)
    assert checked >= sum(news) // 2


def _jax_teacher_forced(jcfg, jparams, prompts, gens, kv_quant):
    """JAX's fp32 logits at every served position of each request: the
    packed prefill's last prompt position, then JAX's decode step (over fp
    or int8 pages) fed the served tokens one at a time."""
    B = len(prompts)
    toks, seg, pos, offs = _pack(prompts)
    jx, jks, jvs = _jax_packed(jcfg, jparams, toks, seg, pos,
                               kv_quant == "int8")
    jc = jpd.PagedKVCache(jcfg, num_pages=48, pages_max=6, batch=B,
                          page=PAGE, kv_quant=kv_quant)
    spans = []
    for slot, (p, off) in enumerate(zip(prompts, offs)):
        jc.alloc_row(slot, len(p))
        W = -(-len(p) // PAGE) * PAGE
        spans.append((slot, jks[:, off:off + W], jvs[:, off:off + W],
                      len(p), 0))
    jc.write_pages_batch(spans)
    last = jnp.asarray([off + len(p) - 1 for p, off in zip(prompts, offs)])
    first = _jax_logits(jcfg, jparams, jx[0, last])
    out = [[first[i]] for i in range(B)]
    step = jpd.make_paged_decode_step(jcfg, kv_quant=kv_quant,
                                      with_logits=True)
    key = jax.random.PRNGKey(0)
    for j in range(max(len(g) for g in gens) - 1):
        rows = [i for i, g in enumerate(gens) if j + 1 < len(g)]
        for i in rows:
            jc.ensure_capacity(i)
        tok = np.zeros(B, np.int32)
        tok[rows] = [gens[i][j] for i in rows]
        *pools, _, logits = step(jparams, *_pools(jc),
                                 jnp.asarray(jc.tables.copy()),
                                 jnp.asarray(jc.lens.copy()),
                                 jnp.asarray(tok), key)
        if kv_quant == "int8":
            jc.kpool, jc.vpool, jc.kscale, jc.vscale = pools
        else:
            jc.kpool, jc.vpool = pools
        logits = np.asarray(logits)
        for i in rows:
            out[i].append(logits[i])
            jc.lens[i] += 1
    return [np.stack(o) for o in out]


# (int8 weights, kv_quant) of each int8 serving lane
INT8_LANES = {"w8-kvfp": (True, None), "wfp-kv8": (False, "int8"),
              "w8-kv8": (True, "int8")}


@pytest.mark.parametrize("lane", list(INT8_LANES))
def test_int8_engine_equals_solo_runs_and_jax_argmax(models, qparams, lane):
    jcfg, tcfg, jparams, tparams = models
    w8, kv_quant = INT8_LANES[lane]
    if w8:
        jparams, tparams = qparams
    prompts = _prompts([5, 16, 1, 33, 20], seed=4)
    news = [8, 6, 9, 5, 7]
    eng, cache = _engine(tcfg, tparams, kv_quant=kv_quant)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    done = {r.rid: r for r in eng.run_to_completion()}
    assert sorted(done) == rids and eng.prefill_calls >= 2
    assert cache.audit()["owned"] == 0
    gens = [done[r].generated for r in rids]
    # (a) lane == solo, token for token
    for gen, p, n in zip(gens, prompts, news):
        assert gen == _solo(tcfg, tparams, p, n, kv_quant)
    # (b) JAX's own int8 path, teacher-forced: its argmax wherever its
    # top-2 margin is > 1e-3
    checked = 0
    ref = _jax_teacher_forced(jcfg, jparams, prompts, gens, kv_quant)
    for i, (gen, rows) in enumerate(zip(gens, ref)):
        top2 = np.sort(rows, axis=-1)[:, -2:]
        for j, t in enumerate(gen):
            if top2[j, 1] - top2[j, 0] > 1e-3:
                checked += 1
                assert t == int(rows[j].argmax()), (lane, i, j)
    assert checked >= sum(news) // 2


def test_recompute_preemption_is_token_exact_and_audit_clean(models):
    jcfg, tcfg, jparams, tparams = models
    prompts = _prompts([30, 30, 30], seed=2)
    # 3 rows x 4 pages at the end, 8 usable pages: growth must preempt
    eng, cache = _engine(tcfg, tparams, batch=3, num_pages=9, pages_max=4)
    rids = [eng.submit(p, max_new_tokens=20) for p in prompts]
    done = {}
    steps = 0
    while eng.has_work():
        eng.step()
        cache.audit()
        done.update({r.rid: r for r in eng.finished()})
        steps += 1
        assert steps < 500
    assert eng.preemptions > 0
    assert any(done[r].preempted for r in rids)
    for rid, p in zip(rids, prompts):
        assert done[rid].generated == _solo(tcfg, tparams, p, 20)
    stats = cache.audit()
    assert stats == {"free": 8, "owned": 0, "indexed": 0}


def test_engine_refuses_lanes_not_ported(models):
    _, tcfg, _, tparams = models
    # overlap and decode_horizon are ported (test_torch_serving_overlap.py),
    # prefix caching and packed=False too (test_torch_prefix_cache.py,
    # test_torch_prefill_lanes.py), mixed (test_torch_serving_mixed.py) and
    # spec (test_torch_serving_spec.py); the scheduler policy and tenant
    # quotas are ported (test_torch_serving_qos.py): an engine builds with
    # them, and the TP lanes still refuse beside them
    qos = {"policy": SchedulerPolicy(),
           "tenant_quotas": TenantQuotas(rate_tokens_per_s=10.0)}
    eng, _ = _engine(tcfg, tparams, **qos)
    assert eng.policy is qos["policy"] and eng.quotas is qos["tenant_quotas"]
    for kw in ({"mesh": object()}, {"tp_allreduce": "int8"}):
        with pytest.raises(NotImplementedError):
            _engine(tcfg, tparams, **qos, **kw)
    # the host page tier is ported (tests/test_torch_kv_offload.py): it
    # builds and a row round-trips through it; its TP form stays refused
    cache = tpd.PagedKVCache(tcfg, 8, 2, 1, page=PAGE, host_pages=4,
                             device="cpu")
    cache.alloc_row(0, 20)
    cache.kpool[:, cache.tables[0, :2]] = 1.5
    h = cache.swap_out_row(0)
    assert cache.host.used_pages() == 2 and cache.swap_in_row(0, h) == 20
    assert bool((cache.kpool[:, cache.tables[0, :2]] == 1.5).all())
    assert cache.audit()["host_free"] == 4
    with pytest.raises(NotImplementedError, match="item 7"):
        tpd.PagedKVCache(tcfg, 8, 2, 1, page=PAGE, host_pages=4,
                         mesh=object(), device="cpu")
    # int8 is the one page quantization, as in JAX
    with pytest.raises(ValueError, match="kv_quant"):
        tpd.PagedKVCache(tcfg, 8, 2, 1, page=PAGE, kv_quant="fp8",
                         device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        tpd.make_paged_decode_step(tcfg, kv_quant="int4")
    # generate_auto serves: a uniform batch through the dense
    # make_generate, a ragged one through generate_paged over its own cache
    uni = tpd.generate_auto(tcfg, tparams, [[1, 2], [3, 4]], 2)
    assert torch.equal(uni, tdec.make_generate(tcfg, 2, 2)(
        tparams, torch.tensor([[1, 2], [3, 4]])))
    rag = tpd.generate_auto(tcfg, tparams, [[1, 2], [3]], 2, page=PAGE)
    cache = tpd.PagedKVCache(tcfg, 4, 1, 2, page=PAGE, device="cpu")
    cache.alloc_row(0, 2)
    cache.alloc_row(1, 1)
    assert torch.equal(rag, tpd.generate_paged(
        tcfg, tparams, np.array([[1, 2], [3, 0]]), 2, cache))


def test_submit_validation_and_cancel(models):
    _, tcfg, _, tparams = models
    eng, cache = _engine(tcfg, tparams, max_queue_len=2)
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit([], max_new_tokens=4)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit([1] * 90, max_new_tokens=10)
    a = eng.submit([1, 2, 3], max_new_tokens=50)
    b = eng.submit([4, 5], max_new_tokens=3, stop_sequences=[[999]])
    from paddle_tpu_torch.models.serving_engine import QueueFullError
    with pytest.raises(QueueFullError) as ei:
        eng.submit([6], max_new_tokens=3)
    assert 0.1 <= ei.value.retry_after <= 60.0
    eng.step()
    assert eng.cancel(a) and not eng.cancel(12345)
    done = {r.rid: r for r in eng.run_to_completion()}
    assert done[a].status == "cancelled" and len(done[a].generated) < 50
    assert done[b].status == "ok" and len(done[b].generated) == 3
    assert cache.audit()["owned"] == 0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return _get(req)


def test_http_front_serves_the_engine_tokens(models):
    _, tcfg, _, tparams = models
    prompt = [int(t) for t in _prompts([7], seed=3)[0]]
    want = _solo(tcfg, tparams, prompt, 6)
    eng, _ = _engine(tcfg, tparams)
    srv = GenerationServer(engine=eng)
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        assert generate_http(url, prompt, 6) == want
        assert list(generate_http_stream(url, prompt, 6)) == want
        code, body, _ = _get(url + "/health/live")
        assert code == 200 and json.loads(body) == {"live": True}
        code, body, _ = _get(url + "/health/ready")
        assert code == 200 and json.loads(body) == {"ready": True}
        code, body, _ = _get(url + "/health")
        doc = json.loads(body)
        assert code == 200 and doc["status"] == "ok"
        assert doc["requests_finished"] == 2
        code, _, _ = _post(url + "/generate", {"prompt": [],
                                               "max_new_tokens": 4})
        assert code == 400
        # a priority class is honoured (the class rides to the engine's
        # request), an unknown one is a 400
        code, body, _ = _post(url + "/generate", {"prompt": prompt,
                                                  "max_new_tokens": 6,
                                                  "priority": "high",
                                                  "tenant": "t"})
        assert code == 200 and json.loads(body)["tokens"] == want
        assert "degraded" not in json.loads(body)
        assert [(e["priority"], e["tenant"]) for e in eng.metrics.ring.recent()
                if e["name"] == "request_submitted"][-1] == ("high", "t")
        assert eng._has_priorities
        code, body, _ = _post(url + "/generate", {"prompt": [1],
                                                  "priority": "urgent"})
        assert code == 400 and b"priority" in body
        code, body, _ = _post(url + "/cancel", {"rid": 999})
        assert code == 200 and json.loads(body)["cancelled"] is False
        code, _, _ = _get(url + "/nope")
        assert code == 404
    finally:
        srv.stop()
    assert not srv.is_live()


def test_http_front_full_queue_is_429_with_retry_after(models):
    _, tcfg, _, tparams = models
    eng, _ = _engine(tcfg, tparams, max_queue_len=0)
    srv = GenerationServer(engine=eng)
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        code, _, headers = _post(url + "/generate", {"prompt": [1, 2],
                                                     "max_new_tokens": 2})
        assert code == 429
        assert int(headers["Retry-After"]) >= 1
        code, body, _ = _get(url + "/health/ready")
        assert code == 503 and json.loads(body) == {"ready": False}
    finally:
        srv.stop()


def test_http_front_serves_int8_weights_over_int8_pages(models, qparams):
    """``GenerationServer(cfg, quantize_params_int8(params),
    PagedKVCache(kv_quant="int8"))``: the port quantizes its own weights
    and serves the tokens of the engine over the JAX-quantized ones."""
    _, tcfg, _, tparams = models
    _, tq = qparams
    prompt = [int(t) for t in _prompts([7], seed=5)[0]]
    want = _solo(tcfg, tq, prompt, 6, "int8")
    cache = tpd.PagedKVCache(tcfg, num_pages=48, pages_max=6, batch=4,
                             page=PAGE, kv_quant="int8", device="cpu")
    srv = GenerationServer(tcfg, tdec.quantize_params_int8(tparams), cache)
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        assert generate_http(url, prompt, 6) == want
        assert list(generate_http_stream(url, prompt, 6)) == want
    finally:
        srv.stop()
    assert cache.audit()["owned"] == 0


TRUNK_FLAGS = ("FLAGS_pallas_rms_norm", "FLAGS_pallas_swiglu",
               "FLAGS_pallas_rmsnorm_matmul")
FLAG_SETS = {"A": TRUNK_FLAGS[:2], "B": TRUNK_FLAGS}
FLAG_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1)


@pytest.fixture
def flag_set(request, monkeypatch):
    """Turn a flag set on in both packages and restore both afterwards.
    JAX reads its flags when it traces and memoises its jitted decode step
    and prefill body per config, so the test gives it empty memos."""
    monkeypatch.setattr(jpd, "_step_cache", {})
    monkeypatch.setattr(jpd, "_packed_body_cache", {})
    saved_jax = get_flags(list(TRUNK_FLAGS))
    saved_port = tflags.get_flags(list(TRUNK_FLAGS))
    on = {name: name in FLAG_SETS[request.param] for name in TRUNK_FLAGS}
    set_flags(on)
    tflags.set_flags(on)
    yield request.param
    set_flags(saved_jax)
    tflags.set_flags(saved_port)


@pytest.mark.parametrize("flag_set", ["A", "B"], indirect=True)
def test_flagged_prefill_and_decode_step_logits_match_jax(flag_set,
                                                          monkeypatch):
    from paddle_tpu_torch.ops import rms_norm as trn
    from paddle_tpu_torch.ops import rmsnorm_matmul as trm
    from paddle_tpu_torch.ops import swiglu as tsw
    calls = {"rms_norm": 0, "swiglu": 0, "rmsnorm_matmul": 0}
    for mod, name in ((trn, "rms_norm"), (tsw, "swiglu"),
                      (trm, "rmsnorm_matmul")):
        def spy(*a, _real=mod._fwd, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(mod, "_fwd", spy)
    jcfg = jlp.LlamaPretrainConfig(**FLAG_KW, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**FLAG_KW, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(3), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    models = (jcfg, tcfg, jparams, tparams)
    st = _prefill_wave(models)
    np.testing.assert_allclose(st["tx"].numpy(), np.asarray(st["jx"]), **TOL)
    _teacher_force_steps(models, st, steps=3)
    L = tcfg.num_hidden_layers
    # the prefill wave and three decode steps: ln1, ln2 (set A), the final
    # norm of each decode step; the FFN in every layer of each pass
    passes = 1 + 3
    if flag_set == "A":
        assert calls == {"rms_norm": passes * 2 * L + 3,
                         "swiglu": passes * L, "rmsnorm_matmul": 0}
    else:
        assert calls == {"rms_norm": passes * L + 3, "swiglu": 0,
                         "rmsnorm_matmul": passes * 2 * L}
