"""Fault containment of the port's serving engine on a CUDA card: a narrow
LLaMA (2 layers, hidden 256, head_dim 128, 2 q heads over 1 kv head, bf16)
with random weights.

* (a) a step fault on the overlap lane while dispatches are in flight: the
  quarantine waits on every dropped dispatch's event before its pinned
  ring slot can be written again, drops the device loop state, and the
  graph captured before the fault replays after it (no new capture) with
  the synchronous lane's tokens; with a plane installed, the fault-free
  steady state still makes no synchronizing call outside ``_fetch``;
* (b) a fault inside a graph capture (a host sync in the captured body)
  quarantines its wave, the caller's stream is current again, and the
  next wave captures afresh and serves the synchronous lane's tokens;
* (c) three supervisor restarts over a fresh cache each: the dead engines'
  decode graphs and caches are released (device memory back where it was,
  one graph left), and each rebuilt engine serves;
* (d) a sticky device error (a device-side assert) in a subprocess: the
  engine quarantines, escalates, the supervisor's rebuild raises, and the
  server goes fatal (500 with the text to the pending requests, 503 to a
  new one) in bounded time, never a hang.

Every test needs a card and skips without one; no test draws from the
default CUDA generator (an aborted capture leaves it mid-capture).  The
card machine has no JAX, so run this file there without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serving_faults_cuda.py -q
"""

import gc
import json
import os
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models import paged_decode as pd  # noqa: E402
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine, EngineSupervisor)
from paddle_tpu_torch.testing import faults  # noqa: E402

pytestmark = pytest.mark.cuda

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
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
    faults.uninstall()


def _model():
    cfg = LlamaPretrainConfig(**KW, dtype=torch.bfloat16)
    return cfg, init_params(cfg, seed=0, device="cuda")


def _cache(cfg, num_pages=NUM_PAGES):
    return pd.PagedKVCache(cfg, num_pages=num_pages, pages_max=PAGES_MAX,
                           batch=B, page=PAGE)


def _prompts(cfg, n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(L))
            for L in rng.integers(5, 40, n)]


def _reference(cfg, params, prompts, new):
    """The synchronous lane's tokens for ``prompts`` admitted as one wave,
    the layout the surviving wave has after a quarantine."""
    eng = ContinuousBatchingEngine(cfg, params, _cache(cfg))
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    return [done[r] for r in rids]


def _captured():
    return sum(g.graph is not None for g in gs.graphs())


class _Event:
    """A CUDA event that records who waited on it."""

    def __init__(self, event, log):
        self.event, self.log = event, log

    def synchronize(self):
        self.log.append(self)
        self.event.synchronize()


def test_overlap_quarantine_waits_on_the_dropped_dispatches(card):
    cfg, params = _model()
    prompts = _prompts(cfg)
    ref = _reference(cfg, params, prompts[B:], 12)
    eng = ContinuousBatchingEngine(cfg, params, _cache(cfg), overlap=True,
                                   lookahead=2)
    waited, issued = [], []
    launch = eng._launch

    def tracked():
        e = launch()
        e["event"] = _Event(e["event"], waited)
        issued.append(e["event"])
        return e

    eng._launch = tracked
    for p in prompts:
        eng.submit(p, max_new_tokens=12)
    with faults.plane() as fp:
        fp.inject("step_dispatch", RuntimeError("fault in flight"), nth=4)
        for _ in range(3):
            eng.step()
        dropped = [e["event"] for e in eng._inflight]
        n0 = len(waited)
        eng.step()
    # the 4th dispatch faulted with two dispatches in flight; the
    # quarantine waited on both before dropping them
    assert eng.step_faults == 1 and len(issued) == 3 and len(dropped) == 2
    assert waited[n0:] == dropped
    assert not eng._inflight and eng._dev is None
    captured, replays = _captured(), sum(g.replays for g in gs.graphs())
    assert captured == 1
    # the fault-free steady state with a plane installed: the site's
    # consult is host work, no synchronizing call outside _fetch
    for _ in range(3):                # the next wave admits, the pipe fills
        eng.step()
    fetch = eng._fetch

    def fetch_allowed(*a):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch(*a)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    eng._fetch = fetch_allowed
    with faults.plane() as fp:
        fp.inject("prefill_dispatch", RuntimeError("not consulted"))
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            eng._fetch = fetch
        assert fp.counts["step_dispatch"] >= 3
    done = {r.rid: r for r in eng.finished()}
    done.update({r.rid: r for r in eng.run_to_completion()})
    assert [done[i].status for i in range(B)] == ["error"] * B
    assert all(done[i].error == "RuntimeError: fault in flight"
               for i in range(B))
    assert [done[i].generated for i in range(B, len(prompts))] == ref
    # the graph captured before the fault replayed after it
    assert _captured() == captured
    assert sum(g.replays for g in gs.graphs()) > replays
    assert eng.cache.audit()["owned"] == 0
    assert eng.cache.free_pages() == NUM_PAGES - 1


def test_a_capture_fault_quarantines_and_the_next_wave_recaptures(
        card, monkeypatch):
    """The quarantined sibling of the overlap file's
    test_a_capture_failure_raises_with_no_eager_fallback."""
    cfg, params = _model()
    prompts = _prompts(cfg, n=2, seed=5)
    ref = _reference(cfg, params, prompts[1:], 10)
    eng = ContinuousBatchingEngine(cfg, params, _cache(cfg), overlap=True)
    real = pd._pick_token

    def host_read(logits, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            logits.sum().item()        # a host sync: illegal in a capture
        return real(logits, *a, **k)

    stream = torch.cuda.current_stream()
    monkeypatch.setattr(pd, "_pick_token", host_read)
    eng.submit(prompts[0], max_new_tokens=10)
    eng.step()                         # the capture aborts: quarantined
    monkeypatch.setattr(pd, "_pick_token", real)
    assert eng.step_faults == 1 and not eng._inflight and eng._dev is None
    assert torch.cuda.current_stream() == stream
    assert all(g.graph is None for g in gs.graphs())
    first = eng.finished()
    assert [r.status for r in first] == ["error"]
    eng.submit(prompts[1], max_new_tokens=10)
    done = eng.run_to_completion()
    assert [r.status for r in done] == ["ok"]
    assert [r.generated for r in done] == ref
    assert _captured() == 1
    torch.cuda.synchronize()
    assert eng.cache.audit()["owned"] == 0


def test_three_restarts_over_fresh_caches_release_graphs_and_memory(card):
    cfg, params = _model()
    prompts = _prompts(cfg, n=12, seed=7)
    built = []

    def factory():
        cache = _cache(cfg, num_pages=512)
        built.append(weakref.ref(cache))
        return ContinuousBatchingEngine(cfg, params, cache, overlap=True,
                                        quarantine_faults=False)

    sup = EngineSupervisor(factory, max_restarts=3, window_s=600.0,
                           backoff_s=0.0)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in sup.engine._pools())
    sup.submit(prompts[0], max_new_tokens=8)
    assert sup.run_to_completion()[0].status == "ok"
    old_graph = weakref.ref(gs.graphs()[0])
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for k in range(3):
        with faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError(f"death {k}"), nth=1)
            sup.submit(prompts[1 + k], max_new_tokens=8)
            sup.step()
        assert sup.restarts == k + 1
        sup.submit(prompts[4 + k], max_new_tokens=8)
        assert [r.status for r in sup.run_to_completion()] == ["error", "ok"]
        # the rebuilt engine's own graph, the dead engines' dropped
        assert len(gs.graphs()) == 1
    # the rule's exception holds the last dead engine through its traceback
    del fp
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert old_graph() is None
    assert sum(ref() is not None for ref in built) == 1
    assert abs(after - before) < pool_bytes, (before, after, pool_bytes)
    assert sup.engine.cache.audit()["owned"] == 0


STICKY = textwrap.dedent('''
    import json, os, sys, threading, time
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from paddle_tpu_torch.inference.serving import (GenerationServer,
                                                    generate_http)
    from paddle_tpu_torch.models.llama_pretrain import (
        LlamaPretrainConfig, init_params)
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)

    cfg = LlamaPretrainConfig(vocab_size=512, hidden_size=256,
                              intermediate_size=512, num_hidden_layers=2,
                              num_attention_heads=2, num_key_value_heads=1,
                              dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    cache = PagedKVCache(cfg, num_pages=40, pages_max=8, batch=2, page=16)
    armed = [True]

    def factory():
        eng = ContinuousBatchingEngine(cfg, params, cache,
                                       max_consecutive_faults=1)
        step = eng._step

        def poisoned(*a, **k):
            if armed[0] and eng.decode_steps == 1:
                armed[0] = False
                x = torch.zeros(4, device="cuda")
                x[torch.full((1,), 100, device="cuda")] += 1  # device assert
            return step(*a, **k)

        eng._step = poisoned
        return eng

    srv = GenerationServer(engine_factory=factory, max_restarts=1,
                           restart_backoff_s=0.0)
    url = "http://127.0.0.1:%d" % srv.start()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, 12).tolist() for _ in range(6)]
    codes, texts = {}, {}

    def client(i):
        try:
            generate_http(url, prompts[i], 8, timeout=120)
            codes[i] = 200
        except Exception as e:
            codes[i] = getattr(e, "code", None)
            texts[i] = e.read().decode() if hasattr(e, "read") else str(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    deadline = time.monotonic() + 60
    while srv._fatal is None and time.monotonic() < deadline:
        time.sleep(0.01)
    late = {}
    try:
        generate_http(url, [1, 2, 3], 4, timeout=60)
        late["code"] = 200
    except Exception as e:
        late["code"] = getattr(e, "code", None)
        late["text"] = e.read().decode() if hasattr(e, "read") else str(e)
    print(json.dumps({"codes": codes, "texts": texts, "late": late,
                      "fatal": srv._fatal, "restarts": srv.restarts,
                      "step_faults": srv.engine.step_faults,
                      "seconds": time.monotonic() - t0}), flush=True)
    os._exit(0)
''')


def test_a_sticky_device_error_ends_in_a_fatal_server(card):
    r = subprocess.run([sys.executable, "-c", STICKY, ROOT],
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert lines, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads(lines[-1])
    assert res["fatal"] is not None, res
    assert all(c == 500 for c in res["codes"].values()), res
    assert any("CUDA" in t or "device-side assert" in t
               for t in res["texts"].values()), res
    assert res["late"]["code"] == 503, res
    assert res["seconds"] < 240, res
