"""The disaggregation hand-off on the card: two CUDA caches at a small bf16
config (head_dim 128, so the engines' admissions reach K2 and their decode
steps K1 / K4):

* a row exported from one cache (the gather on the compute stream, the
  device -> host copy on the host tier's side stream), fetched, adopted by
  another cache and restored lands bit for bit, bf16 pages or int8 pages
  with their scale planes;
* the ordering the in-place pools need: pages an export has just freed,
  rewritten by later work on the compute stream before ``export_fetch``,
  leave the fetched bits equal to the pages as exported -- raw writes into
  the reused pages, and a prefill engine's next wave taking the freed
  pages before its records ship.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_disagg_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models.disagg import (  # noqa: E402
    DecodeEngine, PrefillEngine)
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.paged_decode import PagedKVCache  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
PAGE = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gs.clear()
    yield
    gs.clear()


def _cfg():
    return LlamaPretrainConfig(**KW, dtype=torch.bfloat16)


def _pools(cache):
    return [p for p in (cache.kpool, cache.vpool, cache.kscale,
                        cache.vscale) if p is not None]


def _fill(cache, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for p in _pools(cache):
        if p.dtype == torch.float32:
            p.copy_(torch.rand(p.shape, generator=gen, device="cuda") + 0.01)
        else:
            p.copy_(torch.randint(-100, 100, p.shape, generator=gen,
                                  device="cuda").to(p.dtype))


def _rows(cache, b, L):
    npg = -(-L // cache.page)
    return [int(cache.tables[b, j]) for j in range(npg)]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_bitwise_handoff_between_two_caches(card, kv_quant):
    cfg = _cfg()
    src = PagedKVCache(cfg, num_pages=16, pages_max=6, batch=2, page=PAGE,
                       kv_quant=kv_quant, host_pages=8, device="cuda")
    dst = PagedKVCache(cfg, num_pages=16, pages_max=6, batch=2, page=PAGE,
                       kv_quant=kv_quant, host_pages=8, device="cuda")
    _fill(src, 1)
    L = 70
    src.alloc_row(1, L)
    src.lens[1] = L
    snap = [p[:, _rows(src, 1, L)].clone() for p in _pools(src)]
    state = src.export_row(1)
    assert "hids" in state and state["pages"] == 5
    k, v, ks, vs, n = src.export_fetch(state)
    assert n == L and k.device.type == "cpu" and k.dtype == src.kpool.dtype
    handle = dst.adopt_swap(k, v, ks, vs, n)
    dst.alloc_row(0, 20)                 # the restore takes other pages
    assert dst.swap_in_row(1, handle) == L
    got = [p[:, _rows(dst, 1, L)] for p in _pools(dst)]
    for a, b in zip(snap, got):
        assert torch.equal(a, b)
    for c in (src, dst):
        c.release_row(0)
        c.release_row(1)
        assert c.audit()["host_free"] == 8


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_freed_pages_rewritten_before_the_fetch(card, kv_quant):
    """The export's gather is ordered before any later write to the pages
    it frees: a row that takes them and a write into them, both issued
    before ``export_fetch``, leave the fetched bits as exported."""
    cfg = _cfg()
    cache = PagedKVCache(cfg, num_pages=8, pages_max=6, batch=2, page=PAGE,
                         kv_quant=kv_quant, host_pages=8, device="cuda")
    _fill(cache, 2)
    L = 64
    cache.alloc_row(0, L)
    cache.lens[0] = L
    ids = _rows(cache, 0, L)
    snap = [p[:, ids].transpose(0, 1).cpu() for p in _pools(cache)]
    state = cache.export_row(0)
    cache.alloc_row(1, L)                # the free list hands them back
    assert sorted(_rows(cache, 1, L)) == sorted(ids)
    # a long run of work on the compute stream, then the overwrite
    x = torch.randn(4096, 4096, device="cuda")
    for _ in range(20):
        x = x @ x
        x = x / x.norm()
    for p in _pools(cache):
        p[:, ids] = torch.zeros((), dtype=p.dtype, device="cuda") \
            if p.dtype != torch.float32 else 7.0
    k, v, ks, vs, n = cache.export_fetch(state)
    for a, b in zip(snap, [t for t in (k, v, ks, vs) if t is not None]):
        assert torch.equal(a, b)
    cache.release_row(1)
    assert cache.audit()["host_free"] == 8


def test_next_wave_takes_the_freed_pages_before_the_ship(card):
    """A prefill engine's second wave (K2) reuses the pages its first
    wave's exports freed, before any record is fetched; each record then
    ships to a decode engine equal to the pages as its export saw them,
    and the decode engine serves them without a prefill."""
    cfg = _cfg()
    params = init_params(cfg, seed=0, device="cuda")

    def mk(host):
        return PagedKVCache(cfg, num_pages=12, pages_max=8, batch=2,
                            page=PAGE, host_pages=host, device="cuda")

    pe = PrefillEngine(cfg, params, mk(16), metrics_registry=False)
    de = DecodeEngine(cfg, params, mk(32), metrics_registry=False)
    snaps, freed, reused = {}, set(), []
    export_row, alloc_row = pe.cache.export_row, pe.cache.alloc_row

    def spy_export(b):
        ids = _rows(pe.cache, b, int(pe.cache.lens[b]))
        freed.update(ids)
        snap = [p[:, ids].transpose(0, 1).clone()
                for p in (pe.cache.kpool, pe.cache.vpool)]
        state = export_row(b)
        snaps[state["id"]] = snap
        return state

    def spy_alloc(b, L):
        alloc_row(b, L)
        reused.append(bool(set(_rows(pe.cache, b, L)) & freed))

    pe.cache.export_row, pe.cache.alloc_row = spy_export, spy_alloc
    gen = np.random.RandomState(4)
    for L in (40, 33, 47, 29):
        pe.submit(gen.randint(1, 512, (L,)), max_new_tokens=6)
    pe.step()                            # wave 1: admit, export
    pe.step()                            # wave 2 over the freed pages
    assert reused == [False, False, True, True]
    recs = pe.take_handoffs()
    assert len(recs) == 4 and pe.decode_steps == 0
    for rec in recs:
        de.admit_handoff(rec)
        k, v = rec.blobs[:2]
        a, b = snaps[rec.export["id"]]
        assert torch.equal(a.cpu(), k) and torch.equal(b.cpu(), v)
    done = de.run_to_completion()
    assert len(done) == 4 and all(r.status == "ok" for r in done)
    assert all(len(r.generated) == 6 for r in done)
    assert de.prefill_calls == 0 and de.handoff_admits == 4
    pe.cache.audit()
    de.cache.audit()
