"""The speculative lane (``spec=SpecConfig(...)``) on the card, at a small
bf16 config with head_dim 128 and the kernels (K1 / K4 in the draft's
micro-steps, K3 with int8 weights, K5 in the draft's admission prefill):

* the overlap lane (each round replayed from a CUDA graph, chained on the
  device) serves the synchronous spec lane's tokens, token for token, bf16
  or int8 weights over bf16 or int8 target and draft pages, and its steady
  state makes no synchronizing CUDA call outside ``_fetch`` under
  ``torch.cuda.set_sync_debug_mode("error")``; both caches audit clean;
* a synchronous round launches K1 (K4) (gamma + 1) x draft layers times
  and a spec-on admission K5 2 x draft layers times;
* one capture per gamma (an adaptive engine), none when the same requests
  run again, and a flag flip captures anew;
* the lane draws nothing from the default CUDA generator;
* a capture that fails raises (the engine's quarantine off), with no
  eager fallback.

Every test needs a card and skips without one; no test draws from the
default CUDA generator (an aborted capture of an earlier file may leave it
mid-capture).  The card machine has no JAX, so run this file there without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serving_spec_cuda.py -q
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
    ContinuousBatchingEngine, SpecConfig)
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import rope as rp  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
B, PAGE, PAGES_MAX, NUM_PAGES = 4, 16, 8, 64
LENS, NEWS = (5, 17, 33, 40), (24, 20, 12, 30)


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


def _prompts(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, L) for L in LENS]


def _cache(cfg, kv):
    return pd.PagedKVCache(cfg, num_pages=NUM_PAGES, pages_max=PAGES_MAX,
                           batch=B, page=PAGE, kv_quant=kv)


def _engine(cfg, params, kv=None, gamma=3, spec_kw=None, **kw):
    """A spec engine drafting with the target itself -> (engine, cache,
    draft cache)."""
    cache, dcache = _cache(cfg, kv), _cache(cfg, kv)
    spec = SpecConfig(gamma=gamma, draft_cfg=cfg, draft_params=params,
                      draft_cache=dcache, **(spec_kw or {}))
    return (ContinuousBatchingEngine(cfg, params, cache, spec=spec, **kw),
            cache, dcache)


def _serve(eng, prompts):
    for p, n in zip(prompts, NEWS):
        eng.submit(p, max_new_tokens=n)
    return {r.rid: r.generated for r in eng.run_to_completion()}


def _clean(*caches):
    for c in caches:
        assert c.audit()["owned"] == 0


@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "int8"])
def test_overlap_spec_serves_the_sync_spec_lane_with_no_sync(card, w8):
    cfg, params = _model(w8)
    kv = "int8" if w8 else None
    prompts = _prompts(cfg)
    ref_eng, c0, d0 = _engine(cfg, params, kv)
    ref = _serve(ref_eng, prompts)
    _clean(c0, d0)
    assert ref_eng.spec_rounds > 0

    eng, cache, dcache = _engine(cfg, params, kv, overlap=True)
    for p, n in zip(prompts, NEWS):
        eng.submit(p, max_new_tokens=n)
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
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        eng._fetch = fetch
    got = {r.rid: r.generated for r in eng.finished()}
    got.update({r.rid: r.generated for r in eng.run_to_completion()})
    assert got == ref
    assert sum(g.replays for g in gs.graphs()) > 0
    assert not eng._inflight
    _clean(cache, dcache)


@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "int8"])
def test_sync_round_and_admission_launch_counts(card, w8):
    cfg, params = _model(w8)
    kv = "int8" if w8 else None
    eng, cache, dcache = _engine(cfg, params, kv)
    L = cfg.num_hidden_layers
    attr = "launches_q8" if w8 else "launches"
    admit, step = eng._spec_admit, eng._spec_fused()
    k5, k1 = [], []

    def admit_counted(*a):
        n = rp.launches
        admit(*a)
        k5.append(rp.launches - n)

    def step_counted(*a):
        n = getattr(pa, attr)
        out = step(*a)
        k1.append(getattr(pa, attr) - n)
        return out

    eng._spec_admit = admit_counted
    eng._spec_fused = lambda: step_counted
    _serve(eng, _prompts(cfg))
    assert k5 == [2 * L] * len(LENS)            # q and k, a layer
    assert k1 and set(k1) == {(eng.gamma + 1) * L}
    _clean(cache, dcache)


def test_one_capture_per_gamma_and_a_flag_flip_captures_anew(card):
    cfg, params = _model(False)
    eng, cache, dcache = _engine(
        cfg, params, gamma=2, overlap=True,
        spec_kw={"adaptive_gamma": True, "max_gamma": 4})
    prompts = _prompts(cfg)
    _serve(eng, prompts)
    gammas = {g.gamma for g in gs.graphs()}
    assert eng.gamma > 2 and len(gammas) >= 2     # an identical draft grows
    assert all(g.graph is not None and g.replays > 0 for g in gs.graphs())
    assert len({id(g.state) for g in gs.graphs()}) == 1   # one shared state
    captured = len(gs.graphs())
    _serve(eng, prompts)
    assert len(gs.graphs()) == captured           # none after warm-up
    saved = flags.get_flags()
    try:
        flags.set_flags({"FLAGS_pallas_rms_norm": True})
        eng.submit(prompts[0], max_new_tokens=8)
        eng.run_to_completion()
        new = [g for g in gs.graphs() if "rms_norm_fwd" in
               g.capture_launches]
        assert new and all(g.graph is not None for g in new)
    finally:
        flags.set_flags(saved)
    _clean(cache, dcache)


def test_the_spec_lane_draws_nothing_from_the_default_generator(card):
    cfg, params = _model(False)
    before = torch.cuda.default_generators[0].get_state()
    for overlap in (False, True):
        eng, cache, dcache = _engine(cfg, params, overlap=overlap)
        _serve(eng, _prompts(cfg))
        _clean(cache, dcache)
    torch.cuda.synchronize()
    assert torch.equal(torch.cuda.default_generators[0].get_state(), before)


def test_a_spec_capture_failure_raises_with_no_eager_fallback(
        card, monkeypatch):
    # the graph layer's contract, so the engine's wave quarantine is off
    cfg, params = _model(False)
    eng, _, _ = _engine(cfg, params, overlap=True, quarantine_faults=False)
    real = pd._pick_token

    def host_read(logits, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            logits.sum().item()        # a host sync: illegal in a capture
        return real(logits, *a, **k)

    monkeypatch.setattr(pd, "_pick_token", host_read)
    eng.submit(_prompts(cfg)[0], max_new_tokens=8)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.tokens_generated == 0 and eng.spec_rounds == 0
    assert all(g.graph is None and g.replays == 0 for g in gs.graphs())
    torch.cuda.synchronize()
