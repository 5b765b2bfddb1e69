"""The dispatch-ahead and horizon decode steps replayed from CUDA graphs on a
CUDA card (``models/graphed_step.py``): a narrow LLaMA (2 layers, hidden
256, head_dim 128, 2 q heads over 1 kv head, bf16) with random weights,
over bf16 pages and with int8 weights over int8 pages.

* the graphed async step and the graphed horizon step give the eager
  step's bits (tokens, done flags, the chained state and every pool),
  replay after replay, with new tables and lengths written between
  replays;
* a flag flip gives a new capture, never a stale replay;
* steady-state overlap decode (with and without a horizon) makes no
  synchronizing CUDA call outside ``_fetch``, under
  ``torch.cuda.set_sync_debug_mode("error")``, and serves the synchronous
  lane's tokens;
* sampling replays from a graph with the engine's generator registered;
* a capture that fails raises (the engine's quarantine off), and the
  engine does not fall back to the eager step.

Every test needs a card and skips without one.  The card machine has no JAX,
so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serving_overlap_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models import paged_decode as pd  # noqa: E402
from paddle_tpu_torch.models.decode import (  # noqa: E402
    quantize_params_int8)
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
B, PAGE, PAGES_MAX, NUM_PAGES = 4, 16, 8, 40


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gs.clear()
    yield
    gs.clear()


def _model(w8):
    cfg = LlamaPretrainConfig(**KW, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    return cfg, quantize_params_int8(params) if w8 else params


def _pools(cfg, q8, seed):
    """Random pools (every page written, as after many admissions)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (cfg.num_hidden_layers, NUM_PAGES, cfg.num_key_value_heads,
             PAGE, cfg.head_dim)
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if not q8:
        return [k.bfloat16(), v.bfloat16()]
    kq, ks = pd.quantize_kv_token(k)
    vq, vs = pd.quantize_kv_token(v)
    return [kq, vq, ks, vs]


def _state(rng, cfg):
    """Random tables (distinct pages a row), lengths, tokens, a mask with
    one row off and budgets, as device tensors."""
    perm = rng.permutation(np.arange(1, NUM_PAGES))[:B * PAGES_MAX]
    tables = perm.reshape(B, PAGES_MAX).astype(np.int32)
    lens = rng.integers(0, PAGES_MAX * PAGE - 8, B).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, B)
    active = np.ones(B, bool)
    active[1] = False
    remaining = rng.integers(1, 6, B)
    dev = "cuda"
    return [torch.from_numpy(a).to(dev)
            for a in (tables, lens, tok, active, remaining)]


@pytest.mark.parametrize("multi", [False, True], ids=["async", "horizon3"])
@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "int8"])
def test_graphed_step_equals_eager_bit_for_bit(card, multi, w8):
    cfg, params = _model(w8)
    kv = "int8" if w8 else None
    H = 3 if multi else 1
    pools_g = _pools(cfg, w8, 1)
    pools_e = [p.clone() for p in pools_g]
    g = gs.decode_graph(cfg, H, multi, 0.0, kv, 0, 1.0, params, pools_g, B,
                        PAGES_MAX, torch.device("cuda"))
    fn = (pd.make_paged_decode_step_multi(cfg, H, kv_quant=kv) if multi
          else pd.make_paged_decode_step_async(cfg, kv_quant=kv))
    eos = torch.tensor(7, device="cuda")
    rng = np.random.default_rng(0)
    for rnd in range(3):
        # new tables and lengths (and the rest of the state) each round
        tables, lens, tok, active, remaining = _state(rng, cfg)
        for buf, t in zip((g.tables, g.lens, g.tok, g.active, g.remaining),
                          (tables, lens, tok, active, remaining)):
            buf.copy_(t)
        g.eos.copy_(eos)
        out = g(params, pools_g).clone()
        res = fn(params, *pools_e, tables, lens, tok, active, remaining,
                 eos)[len(pools_e):]
        if multi:
            toks, dones, tok2, lens2, rem2, act2 = res
        else:
            tok2, lens2, rem2, act2, done = res
            toks, dones = tok2[None], done[None]
        torch.cuda.synchronize()
        assert torch.equal(out[0], toks), rnd
        assert torch.equal(out[1], dones.long()), rnd
        for buf, want in ((g.tok, tok2), (g.lens, lens2),
                          (g.remaining, rem2), (g.active, act2)):
            assert torch.equal(buf, want), rnd
        for a, b in zip(pools_g, pools_e):
            assert torch.equal(a, b), rnd
    assert g.replays == 3
    # the kernels of the path went into the graph, once a micro-step and
    # layer (K1 or K4) and once a matmul (K3, int8 weights)
    L = cfg.num_hidden_layers
    attn = "paged_decode_attention_q8" if w8 else "paged_decode_attention"
    assert g.capture_launches[attn] == H * L
    if w8:
        assert g.capture_launches["int8_matmul"] == H * (7 * L + 1)


def test_a_flag_flip_gives_a_new_capture(card):
    cfg, params = _model(False)
    pools = _pools(cfg, False, 2)
    dev = torch.device("cuda")
    saved = flags.get_flags(["FLAGS_pallas_rms_norm"])

    def graph():
        return gs.decode_graph(cfg, 1, False, 0.0, None, 0, 1.0, params,
                               pools, B, PAGES_MAX, dev)

    try:
        g0 = graph()
        g0(params, pools)
        assert graph() is g0
        flags.set_flags({"FLAGS_pallas_rms_norm": True})
        g1 = graph()
        assert g1 is not g0 and g1.graph is None
        g1(params, pools)
        # hidden 256 takes the rms_norm kernel: ln1, ln2 a layer + final
        assert g1.capture_launches["rms_norm_fwd"] == \
            2 * cfg.num_hidden_layers + 1
        assert "rms_norm_fwd" not in g0.capture_launches
    finally:
        flags.set_flags(saved)
    assert graph() is g0


def _engine(cfg, params, kv=None, **kw):
    cache = pd.PagedKVCache(cfg, num_pages=NUM_PAGES, pages_max=PAGES_MAX,
                            batch=B, page=PAGE, kv_quant=kv)
    return ContinuousBatchingEngine(cfg, params, cache, **kw), cache


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, L) for L in (5, 17, 33, 40)]


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "int8"])
def test_steady_state_overlap_makes_no_sync_outside_fetch(card, H, w8):
    cfg, params = _model(w8)
    kv = "int8" if w8 else None
    prompts = _prompts(cfg)
    ref_eng, _ = _engine(cfg, params, kv)
    for p in prompts:
        ref_eng.submit(p, max_new_tokens=30)
    ref = {r.rid: r.generated for r in ref_eng.run_to_completion()}

    eng, cache = _engine(cfg, params, kv, overlap=True, decode_horizon=H)
    for p in prompts:
        eng.submit(p, max_new_tokens=30)
    for _ in range(3):               # admission, capture, the pipeline fills
        eng.step()
    fetch = eng._fetch

    def fetch_allowed(*a):           # the one sanctioned sync point
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch(*a)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    eng._fetch = fetch_allowed
    flushes = eng.pipeline_flushes
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        eng._fetch = fetch
    assert eng.pipeline_flushes == flushes
    got = {r.rid: r.generated for r in eng.finished()}
    got.update({r.rid: r.generated for r in eng.run_to_completion()})
    assert got == ref
    assert not eng._inflight
    assert cache.audit()["owned"] == 0


def test_sampling_replays_with_the_registered_generator(card):
    cfg, params = _model(False)
    eng, cache = _engine(cfg, params, overlap=True, decode_horizon=2,
                         temperature=0.8, top_k=50, seed=1)
    for p in _prompts(cfg):
        eng.submit(p, max_new_tokens=12)
    done = eng.run_to_completion()
    assert len(done) == 4
    for r in done:
        assert len(r.generated) == 12
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert sum(g.replays for g in gs.graphs()) > 0
    assert cache.audit()["owned"] == 0


def test_a_capture_failure_raises_with_no_eager_fallback(card, monkeypatch):
    # the graph layer's contract, so the engine's wave quarantine is off
    # (tests/test_torch_serving_faults_cuda.py holds the quarantined case)
    cfg, params = _model(False)
    eng, _ = _engine(cfg, params, overlap=True, quarantine_faults=False)
    real = pd._pick_token

    def host_read(logits, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            logits.sum().item()        # a host sync: illegal in a capture
        return real(logits, *a, **k)

    monkeypatch.setattr(pd, "_pick_token", host_read)
    eng.submit(_prompts(cfg)[0], max_new_tokens=8)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.tokens_generated == 0
    assert all(g.graph is None and g.replays == 0 for g in gs.graphs())
    torch.cuda.synchronize()
