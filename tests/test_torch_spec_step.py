"""The port's speculative round held against paddle_tpu's on the CPU, at the
2-layer fp32 config of ``tests/test_serving_spec.py`` (page 16) with the
same weights (``params_from_jax``), the same prefilled pages and the same
inputs.

* ``_prefill_chunk_batched`` and ``_spec_verify_body`` (fp and int8 pages):
  x, the logits and the fresh K/V within 1e-5;
* ``make_spec_step`` in its draft-model form (draft == target, where every
  spec-on row accepts all drafts, and a weak 1-layer draft) and its
  prompt-lookup form, over fp or int8 target and draft pages: ``toks``,
  ``dones``, ``emits``, ``accepts`` and the chained state equal to JAX's,
  the pools after the round within 1e-5 (int8: codes equal, scales within
  1e-6), page 0 (the junk page, which takes duplicate writes) left out.

The rows of a round: a spec-on row with a full accept, an inactive row, a
spec-off row (one plain greedy token), a row whose budget ends inside the
accept window and a row that meets eos inside it, crossing a page
boundary.  JAX's TP form (``mesh=``) waits for ROADMAP.md queue 1 item 7.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402

pytestmark = pytest.mark.spec

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
DRAFT_KW = dict(KW, num_hidden_layers=1, hidden_size=32)
PAGE, PAGES_MAX, NUM_PAGES, G = 16, 4, 32, 3
C = G + 1
# per row: prompt length, active, spec on, budget
LENS = (7, 11, 16, 9, 30)
ACTIVE = (True, False, True, True, True)
SPEC_ON = (True, True, False, True, True)
REMAINING = (20, 20, 20, 2, 20)
B = len(LENS)


def _pair(kw, seed):
    jcfg = jlp.LlamaPretrainConfig(**kw, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**kw, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(seed), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(KW, 0), "weak": _pair(DRAFT_KW, 9)}


def _prompts():
    rng = np.random.RandomState(17)
    return [rng.randint(1, 128, (L,)) for L in LENS]


def _caches(pair, kv_quant, claim):
    """A JAX cache and a port cache holding the same prefilled prompts (the
    JAX dense prefill's K/V, copied over), ``claim`` more tokens of pages a
    row -> (jax cache, port cache, first greedy tokens [B])."""
    jcfg, tcfg, jparams, _ = pair
    jc = jpd.PagedKVCache(jcfg, num_pages=NUM_PAGES, pages_max=PAGES_MAX,
                          batch=B, page=PAGE, kv_quant=kv_quant)
    tc = tpd.PagedKVCache(tcfg, num_pages=NUM_PAGES, pages_max=PAGES_MAX,
                          batch=B, page=PAGE, kv_quant=kv_quant,
                          device="cpu")
    prompts = _prompts()
    Sp = PAGES_MAX * PAGE // 2
    toks = np.zeros((B, Sp), np.int64)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
        for c in (jc, tc):
            c.alloc_row(b, len(p))
    x, ks, vs = jax.jit(jpd._prefill(jcfg))(jparams, jnp.asarray(toks))
    jc.write_pages_batch([(b, ks[:, b], vs[:, b], LENS[b], 0)
                          for b in range(B)])
    for name in ("kpool", "vpool", "kscale", "vscale"):
        if getattr(jc, name) is not None:
            getattr(tc, name).copy_(torch.from_numpy(
                np.array(getattr(jc, name))))
    for c in (jc, tc):
        c.ensure_capacity_batch([(b, claim) for b in range(B)])
    np.testing.assert_array_equal(jc.tables, tc.tables)
    h = jlp._rms_norm(x[np.arange(B), np.asarray(LENS) - 1],
                      jparams["final_norm"], jcfg.rms_norm_eps)
    first = np.asarray(jnp.argmax(jlp._mm(h, jparams["lm_head"],
                                          jcfg.dtype), -1))
    return jc, tc, first


def _pools(c, q8):
    names = ("kpool", "vpool", "kscale", "vscale") if q8 else \
        ("kpool", "vpool")
    return [getattr(c, n) for n in names]


def _check_pools(got, want):
    """The pools after a round, page 0 left out."""
    for t, w in zip(got, want):
        t, w = t.numpy()[:, 1:], np.asarray(w)[:, 1:]
        if t.dtype == np.int8:
            np.testing.assert_array_equal(t, w)
        elif t.ndim == 4:                          # int8 pages' scales
            np.testing.assert_allclose(t, w, atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(t, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_batched_verify_matches_jax(models, kv_quant):
    jcfg, tcfg, jparams, tparams = models["target"]
    q8 = kv_quant == "int8"
    jc, tc, first = _caches(models["target"], kv_quant, C)
    rng = np.random.RandomState(3)
    cand = np.concatenate([first[:, None], rng.randint(1, 128, (B, G))], 1)
    lens = np.asarray(LENS, np.int32)
    sc = [jnp.asarray(np.asarray(jc.kscale)), jnp.asarray(
        np.asarray(jc.vscale))] if q8 else [jnp.zeros((1,))] * 2
    jx, jks, jvs = jax.jit(jpd._spec_verify_body(jcfg, q8))(
        jparams, jnp.asarray(cand), jc.kpool, jc.vpool, *sc,
        jnp.asarray(jc.tables), jnp.asarray(lens))
    body = tpd._spec_verify_body(tcfg, q8)
    assert tpd._spec_verify_body(tcfg, q8) is body           # memoised
    tx, tks, tvs = body(tparams, torch.from_numpy(cand), tc.kpool, tc.vpool,
                        tc.kscale, tc.vscale, torch.from_numpy(jc.tables),
                        torch.from_numpy(lens))
    for got, want in ((tx, jx), (tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    jlog = jlp._mm(jlp._rms_norm(jx, jparams["final_norm"],
                                 jcfg.rms_norm_eps), jparams["lm_head"],
                   jcfg.dtype)
    tlog = tlp._mm(tlp._rms_norm(tx, tparams["final_norm"],
                                 tcfg.rms_norm_eps), tparams["lm_head"],
                   tcfg.dtype)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=0)
    if not q8:
        jx2, jks2, _ = jpd._prefill_chunk_batched(jcfg)(
            jparams, jnp.asarray(cand), jc.kpool, jc.vpool,
            jnp.asarray(jc.tables), jnp.asarray(lens))
        tx2, tks2, _ = tpd._prefill_chunk_batched(tcfg)(
            tparams, torch.from_numpy(cand), tc.kpool, tc.vpool,
            torch.from_numpy(jc.tables), torch.from_numpy(lens))
        np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tks2.numpy(), np.asarray(jks2),
                                   atol=1e-5, rtol=0)


def _loop_state(first):
    """The engine's loop state after admission, as numpy arrays."""
    return dict(lens=np.asarray(LENS, np.int32), tok=first.astype(np.int64),
                prev=np.asarray([p[-1] for p in _prompts()], np.int64),
                active=np.asarray(ACTIVE), remaining=np.asarray(
                    REMAINING, np.int64), spec_on=np.asarray(SPEC_ON))


def _greedy_oracle(models, kv_quant, first):
    """Each row's first G + 1 greedy tokens after ``tok``, through JAX's
    prompt-lookup round fed its own picks one position at a time."""
    jcfg, _, jparams, _ = models["target"]
    q8 = kv_quant == "int8"
    st = _loop_state(first)
    fn = jpd.make_spec_step(jcfg, G, kv_quant=kv_quant)
    drafts = np.zeros((B, G), np.int64)
    for j in range(G + 1):
        jc, _, _ = _caches(models["target"], kv_quant, C)
        out = fn(jparams, *_pools(jc, q8), jnp.asarray(jc.tables),
                 jnp.asarray(st["lens"]), jnp.asarray(st["tok"]),
                 jnp.asarray(drafts), jnp.ones((B,), bool),
                 jnp.full((B,), 99, jnp.int64), jnp.ones((B,), bool),
                 jnp.asarray(-1, jnp.int64), jax.random.PRNGKey(0))
        toks = np.asarray(out[4 if q8 else 2])           # [C, B]
        if j < G:
            drafts[:, j] = toks[j]
    return toks.T                                        # [B, C]


CASES = [("draft-same", None, None), ("draft-same", "int8", "int8"),
         ("draft-weak", None, "int8"), ("draft-weak", "int8", None),
         ("lookup", None, None), ("lookup", "int8", None)]


@pytest.mark.parametrize("source,kv_quant,draft_kv_quant", CASES,
                         ids=["-".join(str(v) for v in c) for c in CASES])
def test_spec_step_matches_jax(models, source, kv_quant, draft_kv_quant):
    jcfg, tcfg, jparams, tparams = models["target"]
    q8, dq8 = kv_quant == "int8", draft_kv_quant == "int8"
    jc, tc, first = _caches(models["target"], kv_quant, C)
    st = _loop_state(first)
    greedy = _greedy_oracle(models, kv_quant, first)
    # row 4 meets eos at its second committed token
    eos = int(greedy[4, 1])
    draft = source != "lookup"
    targs_j = [jparams]
    targs_t = [tparams]
    dpools_t = []
    if draft:
        dpair = models["target"] if source == "draft-same" else \
            models["weak"]
        jdc, tdc, _ = _caches(dpair, draft_kv_quant, C)
        targs_j.append(dpair[2])
        targs_t.append(dpair[3])
        dpools_t = _pools(tdc, dq8)
    jpools = [jnp.array(p, copy=True) for p in _pools(jc, q8)]
    tpools = _pools(tc, q8)
    jargs = targs_j + jpools
    targs = targs_t + tpools
    if draft:
        jargs += [jnp.array(p, copy=True) for p in _pools(jdc, dq8)]
        targs += dpools_t
    jargs.append(jnp.asarray(jc.tables))
    targs.append(torch.from_numpy(tc.tables.copy()))
    if draft:
        jargs.append(jnp.asarray(jdc.tables))
        targs.append(torch.from_numpy(tdc.tables.copy()))
    jargs += [jnp.asarray(st["lens"]), jnp.asarray(st["tok"])]
    targs += [torch.from_numpy(st["lens"]), torch.from_numpy(st["tok"])]
    if draft:
        jargs.append(jnp.asarray(st["prev"]))
        targs.append(torch.from_numpy(st["prev"]))
    else:
        # row 0 proposes the greedy run (a full accept), row 3 one right
        # then a wrong one, row 4 the greedy run through its eos
        drafts = greedy[:, :G].copy()
        drafts[3, 1:] = (drafts[3, 1:] + 1) % 128
        jargs.append(jnp.asarray(drafts))
        targs.append(torch.from_numpy(drafts))
    for k in ("active", "remaining", "spec_on"):
        jargs.append(jnp.asarray(st[k]))
        targs.append(torch.from_numpy(st[k]))
    jargs += [jnp.asarray(eos, jnp.int64), jax.random.PRNGKey(0)]
    targs.append(torch.tensor(eos))
    dcfg_j = None if not draft else dpair[0]
    dcfg_t = None if not draft else dpair[1]
    jfn = jpd.make_spec_step(jcfg, G, draft_cfg=dcfg_j, kv_quant=kv_quant,
                             draft_kv_quant=draft_kv_quant)
    tfn = tpd.make_spec_step(tcfg, G, draft_cfg=dcfg_t, kv_quant=kv_quant,
                             draft_kv_quant=draft_kv_quant)
    assert tpd.make_spec_step(tcfg, G, draft_cfg=dcfg_t, kv_quant=kv_quant,
                              draft_kv_quant=draft_kv_quant) is tfn
    jout = jfn(*jargs)
    tout = tfn(*targs)
    assert len(tout) == len(jout)
    n = len(tpools) + len(dpools_t)
    for k, (got, want) in enumerate(zip(tout[n:], jout[n:])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"output {k}")
    _check_pools(tout[:len(tpools)], jout[:len(tpools)])
    if draft:
        _check_pools(tout[len(tpools):n], jout[len(tpools):n])
    toks, dones, emits, acc = (t.numpy() for t in tout[n:n + 4])
    n_emit = emits.sum(0)
    # the inactive row emits nothing, the spec-off row its one greedy token
    assert n_emit[1] == 0 and acc[1] == 0 and acc[2] == 0
    assert n_emit[2] == 1 and toks[0, 2] == greedy[2, 0]
    # the budget of row 3 ends inside the window (the weak draft's accepts
    # may leave it one token)
    assert n_emit[3] == min(acc[3] + 1, 2) and dones[n_emit[3] - 1, 3] == (
        n_emit[3] == 2)
    if source != "draft-weak":
        # a full accept on row 0; row 4 stops at its eos
        assert acc[0] == G and n_emit[0] == C
        assert list(toks[:, 0]) == list(greedy[0])
        assert n_emit[4] == 2 and dones[1, 4] and toks[1, 4] == eos
    if source == "lookup":
        assert acc[3] == 1


def test_spec_step_validates(models):
    tcfg = models["target"][1]
    with pytest.raises(NotImplementedError, match="item 7"):
        tpd.make_spec_step(tcfg, 3, mesh=object())
    with pytest.raises(ValueError, match="gamma"):
        tpd.make_spec_step(tcfg, 0)
    with pytest.raises(ValueError, match="kv_quant"):
        tpd.make_spec_step(tcfg, 3, kv_quant="fp8")
