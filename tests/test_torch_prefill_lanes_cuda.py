"""The admission lanes of this slice on a CUDA card: a narrow LLaMA (2
layers, hidden 256, head_dim 128, 2 q heads over 1 kv head, bf16) with
random weights.

* the packed prefill's prefix-history form (``_packed_prefill_body(cfg,
  q8, with_hist=True)``, K2 over the stream) against the same body with K2
  replaced by its plain version, over bf16 pages and over int8 pages, with
  history slots from the pool and from the stream: the history slots' K/V
  are the pool's (dequantized) values and the stream's, bit for bit; the
  hidden states and the computed K/V within 5e-2 abs + 5e-2 rel (bf16
  through two layers, attention summed in another order);
* the dense prefill (``_prefill``) launches K5 on q and k in every layer
  and matches the same prefill with K5 replaced by its plain version
  within 2e-2 (the kernel rounds as the plain version does);
* ``generate_paged`` with ``fused=True`` gives ``fused=False``'s tokens
  and pages bit for bit, over bf16 and over int8 pages.

Every test needs a card and skips without one.  The card machine has no JAX,
so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_prefill_lanes_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as pd  # noqa: E402
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import rope as rp  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
PAGE, NUM_PAGES = 16, 40
TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _model():
    cfg = LlamaPretrainConfig(**KW, dtype=torch.bfloat16)
    return cfg, init_params(cfg, seed=0, device="cuda")


def _pools(cfg, q8, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (cfg.num_hidden_layers, NUM_PAGES, cfg.num_key_value_heads,
             PAGE, cfg.head_dim)
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if not q8:
        return [k.bfloat16(), v.bfloat16(), None, None]
    kq, ks = pa.quantize_kv_token(k)
    vq, vs = pa.quantize_kv_token(v)
    return [kq, vq, ks, vs]


def _hist_stream(rng):
    """Three segments and a sentinel tail in a 256-slot stream: seg 0
    computes 3 pages; seg 1 takes 2 pool pages then computes; seg 2 takes
    a pool page, then seg 0's second page from the stream, then computes
    a ragged tail."""
    T = 256
    toks = rng.integers(0, KW["vocab_size"], (1, T))
    seg = np.full((1, T), 3, np.int32)
    pos = np.zeros((1, T), np.int32)
    hp, hs = np.zeros(T, np.int32), np.zeros(T, np.int32)
    ph, sh = np.zeros(T, bool), np.zeros(T, bool)
    ss = np.zeros(T, np.int32)
    spans = [(0, 48), (48, 64 + 16), (128, 64 + 9)]
    for i, (off, W) in enumerate(spans):
        seg[0, off:off + W] = i
        pos[0, off:off + W] = np.arange(W)
    for off, pids in ((48, (5, 9)), (128, (12,))):
        for j, pid in enumerate(pids):
            a = off + j * PAGE
            hp[a:a + PAGE], hs[a:a + PAGE] = pid, np.arange(PAGE)
            ph[a:a + PAGE] = True
    a = 128 + PAGE
    ss[a:a + PAGE] = PAGE + np.arange(PAGE)          # seg 0's page 1
    sh[a:a + PAGE] = True
    return [torch.from_numpy(x).cuda() for x in
            (toks, seg, pos, hp, hs, ph, ss, sh)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_packed_prefill_with_history_matches_plain(card, q8, monkeypatch):
    cfg, params = _model()
    pools = _pools(cfg, q8)
    toks, seg, pos, hp, hs, ph, ss, sh = _hist_stream(
        np.random.default_rng(2))
    run = pd._packed_prefill_body(cfg, q8, with_hist=True)
    n0 = fv.launches
    x, ks, vs = run(params, toks, seg, pos, *pools, hp, hs, ph, ss, sh)
    torch.cuda.synchronize()
    assert fv.launches - n0 == cfg.num_hidden_layers
    monkeypatch.setattr(pd, "flash_attention_segmented",
                        lambda q, k, v, seg, causal=False:
                        fv.segmented_sdpa_plain(q, k, v, seg, causal))
    xp, ksp, vsp = run(params, toks, seg, pos, *pools, hp, hs, ph, ss, sh)
    torch.testing.assert_close(x.float(), xp.float(), **TOL)
    torch.testing.assert_close(ks.float(), ksp.float(), **TOL)
    torch.testing.assert_close(vs.float(), vsp.float(), **TOL)
    # the history slots: the pool's values, and seg 0's for the stream
    for got, pool, scale in ((ks, pools[0], pools[2]),
                             (vs, pools[1], pools[3])):
        want = pool[:, hp.long(), :, hs.long()]       # [T, Lyr, nkv, d]
        if q8:
            want = want.float() * scale[:, hp.long(), :, hs.long()][..., None]
        got = got.permute(1, 0, 2, 3)
        assert torch.equal(got[ph], want[ph].to(got.dtype))
        assert torch.equal(got[sh], got[ss[sh].long()])


def test_dense_prefill_launches_k5_and_matches_plain(card, monkeypatch):
    cfg, params = _model()
    # a generator of its own: the process's default CUDA generator is left
    # mid-capture by an aborted graph capture in another card test
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, KW["vocab_size"], (4, 96), generator=gen,
                           device="cuda")
    n0 = rp.launches
    x, ks, vs = pd._prefill(cfg)(params, prompt)
    torch.cuda.synchronize()
    assert rp.launches - n0 == 2 * cfg.num_hidden_layers
    monkeypatch.setattr(tlp, "fused_rope",
                        lambda t, cos, sin: rp._composite(t, cos, sin, False))
    xp, ksp, vsp = pd._prefill(cfg)(params, prompt)
    for a, b in ((x, xp), (ks, ksp), (vs, vsp)):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_paged_fused_equals_unfused_bit_for_bit(card, kv_quant):
    cfg, params = _model()
    lens = [9, 40, 23]
    prompt = torch.zeros((3, 40), dtype=torch.long, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for b, L in enumerate(lens):
        prompt[b, :L] = torch.randint(1, KW["vocab_size"], (L,),
                                      generator=gen, device="cuda")
    out = {}
    for fused in (True, False):
        cache = pd.PagedKVCache(cfg, num_pages=NUM_PAGES, pages_max=6,
                                batch=3, page=PAGE, kv_quant=kv_quant)
        for b, L in enumerate(lens):
            cache.alloc_row(b, L)
        n0 = rp.launches
        toks = pd.generate_paged(cfg, params, prompt, 24, cache,
                                 fused=fused)
        torch.cuda.synchronize()
        assert rp.launches - n0 == 2 * cfg.num_hidden_layers
        pages = {}
        for b in range(3):
            for j, pid in enumerate(cache._owned[b]):
                pages[(b, j)] = pid
        out[fused] = (toks, cache, pages)
    (t1, c1, p1), (t0, c0, p0) = out[True], out[False]
    assert torch.equal(t1, t0)
    assert t1.shape == (3, 24)
    np.testing.assert_array_equal(c1.lens, c0.lens)
    # the same slots of each row hold the same bits (the page ids differ:
    # the fused form claims a row's pages at once)
    names = ("kpool", "vpool") + (("kscale", "vscale") if kv_quant else ())
    for b in range(3):
        n = int(c1.lens[b])
        for j in range(-(-n // PAGE)):
            for name in names:
                a = getattr(c1, name)[:, p1[(b, j)]]
                z = getattr(c0, name)[:, p0[(b, j)]]
                w = min(PAGE, n - j * PAGE)
                assert torch.equal(a[:, :, :w], z[:, :, :w]), (b, j, name)
