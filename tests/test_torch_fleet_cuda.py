"""QoS and the in-process fleet of the port on a CUDA card: a narrow LLaMA
(2 layers, hidden 256, head_dim 128, 2 q heads over 1 kv head, bf16) with
random weights from its own generator (``init_params`` seeds a
``torch.Generator``; nothing here draws from the default CUDA one).

* priority preemption on the overlap lane (each step replayed from a CUDA
  graph): a high request takes the youngest low's seat, the victim resumes,
  and every request gets the synchronous lane's tokens;
* the same with a host page tier: the victim's pages swap out and back bit
  for bit;
* a fleet scaled up to three replicas and back to one: the retired and the
  replaced replicas give their pools and decode graphs back (allocated
  memory within 64 MiB of the one-replica fleet's), and every request
  finishes with the single engine's tokens.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fleet_cuda.py -q
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.fleet import FleetRouter  # noqa: E402
from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models import paged_decode as pd  # noqa: E402
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from paddle_tpu_torch.testing import faults  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
B, PAGE, PAGES_MAX, NUM_PAGES = 4, 16, 8, 40
MEM_SLACK = 64 * 2**20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gs.clear()
    yield
    gs.clear()
    faults.uninstall()


@pytest.fixture
def model(card):
    cfg = LlamaPretrainConfig(**KW, dtype=torch.bfloat16)
    return cfg, init_params(cfg, seed=0, device="cuda")


def _cache(cfg, num_pages=NUM_PAGES, **kw):
    return pd.PagedKVCache(cfg, num_pages=num_pages, pages_max=PAGES_MAX,
                           batch=B, page=PAGE, **kw)


def _prompts(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(L))
            for L in rng.integers(8, 40, n)]


def _preempt_run(cfg, params, prompts, cache_kw=None, **engine_kw):
    """B lows fill the batch, then two highs arrive: -> (tokens by
    submission index, preemption events (rid, mode), the engine)."""
    eng = ContinuousBatchingEngine(cfg, params, _cache(cfg, **(cache_kw or
                                                                {})),
                                   **engine_kw)
    if cache_kw:
        eng.offload_swap_gbps = 1e9           # force the swap
    rids = [eng.submit(p, max_new_tokens=16, priority="low")
            for p in prompts[:B]]
    eng.step()
    eng.step()
    rids += [eng.submit(p, max_new_tokens=16, priority="high")
             for p in prompts[B:B + 2]]
    done = {r.rid: r for r in eng.run_to_completion()}
    assert all(r.status == "ok" for r in done.values())
    victims = [(e["rid"], e["mode"]) for e in eng.metrics.ring.recent()
               if e["name"] == "preemption"]
    assert eng.cache.audit()["owned"] == 0
    return [list(done[r].generated) for r in rids], victims, rids, eng


def test_priority_preemption_on_the_overlap_lane_serves_sync_tokens(model):
    cfg, params = model
    prompts = _prompts(cfg, B + 2)
    sync, sv, rids, _ = _preempt_run(cfg, params, prompts)
    graphs0 = len(gs.graphs())
    over, ov, _, eng = _preempt_run(cfg, params, prompts, overlap=True)
    assert over == sync
    # the lows go youngest first; no high is churned
    assert [v[0] for v in ov] == [v[0] for v in sv] == [rids[3], rids[2]]
    assert eng.preemptions == 2 and eng.pipeline_flushes >= 2
    assert len(gs.graphs()) > graphs0, "the overlap lane never replayed"
    assert sum(g.replays for g in gs.graphs()) > 0


def test_priority_preemption_swaps_the_victim_bit_for_bit(model):
    cfg, params = model
    prompts = _prompts(cfg, B + 2, seed=6)
    sync, _, _, _ = _preempt_run(cfg, params, prompts)
    parked, restored = {}, {}
    real_out, real_in = pd.PagedKVCache.swap_out_row, \
        pd.PagedKVCache.swap_in_row

    def pages(cache, b, n):
        pids = list(cache._owned[b][:n])
        return cache.kpool[:, pids].clone(), cache.vpool[:, pids].clone()

    def swap_out(self, b):
        kv = pages(self, b, -(-int(self.lens[b]) // self.page))
        handle = real_out(self, b)
        parked[handle] = kv
        return handle

    def swap_in(self, b, handle):
        n = real_in(self, b, handle)
        restored[handle] = pages(self, b, len(parked[handle][0][0]))
        return n

    pd.PagedKVCache.swap_out_row = swap_out
    pd.PagedKVCache.swap_in_row = swap_in
    try:
        got, victims, _, eng = _preempt_run(
            cfg, params, prompts, cache_kw={"host_pages": 16},
            overlap=True)
    finally:
        pd.PagedKVCache.swap_out_row = real_out
        pd.PagedKVCache.swap_in_row = real_in
    assert got == sync
    assert len(victims) == 2 and all(m == "swap" for _, m in victims)
    assert eng.resumes_swapped == 2 and set(restored) == set(parked)
    for h, kv in parked.items():
        for a, b in zip(kv, restored[h]):
            assert torch.equal(a, b)


def test_scale_up_then_retire_gives_the_memory_back(model):
    """One replica serves; two more join, one of them dies at its first
    step (its requests fail over) and is replaced; the two added replicas
    retire.  Every request gets the single engine's tokens and the
    allocated memory is back within 64 MiB of the one-replica fleet's."""
    cfg, params = model
    prompts = _prompts(cfg, 12, seed=7)

    def mk():
        # 8,192 pages of 16: a 128 MiB pool, well above the slack
        return ContinuousBatchingEngine(cfg, params,
                                        _cache(cfg, num_pages=8192),
                                        overlap=True)

    ref_eng = ContinuousBatchingEngine(cfg, params, _cache(cfg))
    ref_rids = [ref_eng.submit(p, max_new_tokens=8) for p in prompts]
    ref = {r.rid: list(r.generated) for r in ref_eng.run_to_completion()}
    del ref_eng
    router = FleetRouter([mk], metrics_registry=False)
    router.submit(prompts[0], max_new_tokens=8)
    router.run_to_completion()
    gc.collect()
    torch.cuda.synchronize()
    one = torch.cuda.memory_allocated()
    c0 = router._replicas[0].engine.cache
    pool = sum(t.numel() * t.element_size() for t in (c0.kpool, c0.vpool))
    del c0
    router.add_replica(mk)
    router.add_replica(mk)
    got = {router.submit(p, max_new_tokens=8): i
           for i, p in enumerate(prompts)}
    with faults.plane() as fp:
        # the second replica stepped in the first tick dies
        fp.inject("replica_death", RuntimeError("killed"), nth=2)
        done = router.run_to_completion()
    assert router.deaths == 1 and router.replaces == 1
    assert router.failovers > 0
    assert sorted(got) == sorted(r.rid for r in done)
    for r in done:
        assert r.status == "ok"
        assert list(r.generated) == ref[ref_rids[got[r.rid]]]
    three = torch.cuda.memory_allocated()
    router.retire_replica(1)
    router.retire_replica(2)
    router.step()
    assert [h.state for h in router._replicas] == \
        ["READY", "RETIRED", "RETIRED"]
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert three - after >= 2 * pool, (three, after, pool)
    assert after - one <= MEM_SLACK, (one, after)
