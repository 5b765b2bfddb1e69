"""The host page tier of a CUDA cache (``PagedKVCache(host_pages=N)`` on the
card), at a small bf16 config with the kernels (K2 in the admission, K1 /
K4 in the decode steps):

* the host buffers are pinned; a swap-out's copies run on the side stream
  behind an event, its gathered blocks held until the flush, and a
  swap-in restores every page (and int8 scale) bit for bit into other
  device pages, the pool tensors written in place;
* the swap-out path (gather, side-stream copy) makes no synchronizing
  CUDA call, under ``torch.cuda.set_sync_debug_mode("error")``;
* an engine with the swap forced resumes every preempted request from
  the host tier, on the synchronous and the overlap lanes alike, with the
  same tokens on both, bf16 or int8 pages, the pools and the host tier
  clean after.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kv_offload_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.paged_decode import PagedKVCache  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
PAGE = 16
# two 32-token prompts + 40 new tokens (5 pages a row at the end) over 6
# usable pages: preemption is forced
TIGHT = dict(num_pages=7, pages_max=6, batch=2, page=PAGE)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gs.clear()
    yield
    gs.clear()


def _model():
    cfg = LlamaPretrainConfig(**KW, dtype=torch.bfloat16)
    return cfg, init_params(cfg, seed=0, device="cuda")


def _pools(cache):
    return [p for p in (cache.kpool, cache.vpool, cache.kscale,
                        cache.vscale) if p is not None]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_host_tier_pinned_side_stream_round_trip(card, kv_quant):
    cfg, _ = _model()
    cache = PagedKVCache(cfg, num_pages=12, pages_max=6, batch=2, page=PAGE,
                         kv_quant=kv_quant, host_pages=8, device="cuda")
    host = cache.host
    assert all(b.is_pinned() for b in host._bufs() if b is not None)
    ptrs = [p.data_ptr() for p in _pools(cache)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for p in _pools(cache):
        p.copy_(torch.randint(-100, 100, p.shape, generator=gen,
                              device="cuda").to(p.dtype))
    cache.alloc_row(0, 40)
    ids = [int(cache.tables[0, j]) for j in range(3)]
    snap = [p[:, ids].clone() for p in _pools(cache)]
    handle = cache.swap_out_row(0)
    (hids, blocks, event), = host._pending
    assert event is not None and len(blocks) == len(snap)
    for p in _pools(cache):
        p[:, ids] = 0                    # the freed pages are reused
    cache.alloc_row(1, 30)               # another row takes fresh pages
    assert cache.swap_in_row(0, handle) == 40
    assert not host._pending and host.used_pages() == 0
    got = [p[:, [int(cache.tables[0, j]) for j in range(3)]]
           for p in _pools(cache)]
    for a, b in zip(snap, got):
        assert torch.equal(a, b)
    assert [p.data_ptr() for p in _pools(cache)] == ptrs
    assert cache.restore_dispatches == 1
    cache.audit()


def test_swap_out_makes_no_host_sync(card):
    cfg, _ = _model()
    cache = PagedKVCache(cfg, num_pages=12, pages_max=6, batch=2, page=PAGE,
                         host_pages=8, device="cuda")
    cache.alloc_row(0, 40)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = cache.swap_out_row(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cache.host.flush()
    assert cache.swap_in_row(1, handle) == 40
    cache.release_row(1)
    cache.audit()


def _serve(cfg, params, prompts, new, host_pages, kv_quant, **kw):
    cache = PagedKVCache(cfg, kv_quant=kv_quant, host_pages=host_pages,
                         device="cuda", **TIGHT)
    eng = ContinuousBatchingEngine(cfg, params, cache, **kw)
    eng.offload_swap_gbps = 1e9
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    cache.audit()
    assert cache.free_pages() == cache.num_pages - 1
    assert cache.host is None or cache.host.used_pages() == 0
    return [done[r] for r in rids], eng


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_swap_resumes_token_exact_across_lanes(card, kv_quant):
    cfg, params = _model()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, 32).tolist() for _ in range(2)]
    _, e0 = _serve(cfg, params, prompts, 40, 0, kv_quant)
    assert e0.preemptions > 0 and e0.resumes_recompute > 0
    # a restore is bit for bit, so the graph lane serves the synchronous
    # lane's tokens (a recompute resume re-prefills: its bf16 K / V may
    # differ from the decode-written ones, so its tokens are not compared)
    runs = [_serve(cfg, params, prompts, 40, 16, kv_quant, overlap=overlap)
            for overlap in (False, True)]
    for got, eng in runs:
        assert eng.resumes_swapped > 0 and eng.prefill_tokens_avoided > 0
        assert eng.resumes_recompute == 0
    assert runs[1][0] == runs[0][0]
