"""The mixed prefill + decode tick (``mixed=True``) on the card, at a small
bf16 config with the kernels (K2 over the stream, K1 / K4 in the decode
half, K3 with int8 weights):

* the mixed lane serves the sequential packed lane's tokens, on the
  synchronous and the overlap lanes, bf16 or int8 weights over bf16 or
  int8 pages, with one ``_fetch`` a dispatch and the pool clean after;
* the overlap lane's steady state, mixed ticks chained between graph
  replays included, makes no synchronizing CUDA call outside ``_fetch``
  under ``torch.cuda.set_sync_debug_mode("error")``;
* a fault at a mixed tick quarantines the parked and the decoding rows,
  captures no graph, leaves the pool clean, and the engine then serves.

Every test needs a card and skips without one; the prompts come from the
file's own generators.  The card machine has no JAX, so run this file
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serving_mixed_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models import paged_decode as pd  # noqa: E402
from paddle_tpu_torch.models.decode import (  # noqa: E402
    quantize_params_int8)
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
B, PAGE, PAGES_MAX, NUM_PAGES = 4, 16, 8, 64
MIXED = dict(mixed=True, mixed_token_budget=32)
LENS, NEWS = (5, 17, 33, 60, 40, 9), (24, 20, 12, 10, 14, 8)


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


def _engine(cfg, params, kv=None, **kw):
    cache = pd.PagedKVCache(cfg, num_pages=NUM_PAGES, pages_max=PAGES_MAX,
                            batch=B, page=PAGE, kv_quant=kv)
    return ContinuousBatchingEngine(cfg, params, cache, **kw), cache


def _serve(eng, prompts):
    """Two requests admit first; the rest arrive while they decode."""
    for p, n in zip(prompts[:2], NEWS):
        eng.submit(p, max_new_tokens=n)
    eng.step()
    for p, n in zip(prompts[2:], NEWS[2:]):
        eng.submit(p, max_new_tokens=n)
    return {r.rid: r.generated for r in eng.run_to_completion()}


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "int8"])
def test_mixed_lane_serves_the_sequential_tokens(card, w8, overlap):
    cfg, params = _model(w8)
    kv = "int8" if w8 else None
    prompts = _prompts(cfg)
    ref_eng, _ = _engine(cfg, params, kv)
    ref = _serve(ref_eng, prompts)
    eng, cache = _engine(cfg, params, kv, overlap=overlap, **MIXED)
    fetch = eng._fetch
    fetches = []
    eng._fetch = lambda *a: fetches.append(1) or fetch(*a)
    k2 = fv.launches
    ticks = []
    step = eng._step_mixed

    def counted(*a, **kw):
        n = fv.launches
        out = step(*a, **kw)
        ticks.append(fv.launches - n)
        return out

    eng._step_mixed = counted
    got = _serve(eng, prompts)
    assert got == ref
    assert eng.mixed_ticks == len(ticks) > 0
    # K2 once a layer in every mixed tick
    assert ticks == [cfg.num_hidden_layers] * len(ticks)
    assert fv.launches - k2 >= sum(ticks)
    assert len(fetches) == eng.host_syncs == eng.decode_steps
    assert not eng._inflight and not eng._mixed_pref
    assert cache.audit()["owned"] == 0


@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "int8"])
def test_overlap_mixed_lane_makes_no_sync_outside_fetch(card, w8):
    cfg, params = _model(w8)
    kv = "int8" if w8 else None
    prompts = _prompts(cfg)
    ref_eng, _ = _engine(cfg, params, kv)
    ref = _serve(ref_eng, prompts)

    eng, cache = _engine(cfg, params, kv, overlap=True, **MIXED)
    for p, n in zip(prompts[:2], NEWS):
        eng.submit(p, max_new_tokens=n)
    for _ in range(3):          # admission, capture, the pipeline fills
        eng.step()
    for p, n in zip(prompts[2:], NEWS[2:]):
        eng.submit(p, max_new_tokens=n)
    fetch = eng._fetch

    def fetch_allowed(*a):      # the one sanctioned sync point
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch(*a)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    eng._fetch = fetch_allowed
    ticks, replays = eng.mixed_ticks, sum(g.replays for g in gs.graphs())
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(6):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        eng._fetch = fetch
    # the window held mixed ticks and graph replays chained off them
    assert eng.mixed_ticks - ticks >= 2
    assert sum(g.replays for g in gs.graphs()) > replays
    got = {r.rid: r.generated for r in eng.finished()}
    got.update({r.rid: r.generated for r in eng.run_to_completion()})
    assert got == ref
    assert not eng._inflight
    assert cache.audit()["owned"] == 0


def test_a_mixed_tick_fault_quarantines_and_captures_nothing(card):
    cfg, params = _model(False)
    prompts = _prompts(cfg)
    ref_eng, _ = _engine(cfg, params)
    for p in prompts[4:]:
        ref_eng.submit(p, max_new_tokens=8)
    ref = [r.generated for r in ref_eng.run_to_completion()]

    eng, cache = _engine(cfg, params, overlap=True, **MIXED)
    for p, n in zip(prompts[:2], NEWS):
        eng.submit(p, max_new_tokens=n)
    for _ in range(3):
        eng.step()
    captured = [g for g in gs.graphs() if g.graph is not None]
    assert captured
    eng.submit(prompts[3], max_new_tokens=4)     # 60 tokens: two ticks
    with faults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("injected mixed fault"),
                  nth=1)
        eng.step()                               # carve, then the tick
    assert fp.fired["step_dispatch"] == 1
    assert eng.step_faults == 1 and eng.mixed_ticks == 0
    done = eng.finished()
    assert len(done) == 3
    assert all(r.status == "error" and "injected mixed fault" in r.error
               for r in done)
    assert not eng._mixed_pref and not eng._inflight
    assert cache.audit()["owned"] == 0
    # the engine serves on, with no new capture
    for p in prompts[4:]:
        eng.submit(p, max_new_tokens=8)
    got = [r.generated for r in eng.run_to_completion()]
    assert got == ref
    assert [g for g in gs.graphs() if g.graph is not None] == captured
    assert cache.audit()["owned"] == 0
