"""The port's instrumentation on the CUDA graph lanes, on a CUDA card: a
narrow LLaMA (2 layers, hidden 256, head_dim 128, 2 q heads over 1 kv head,
bf16) with random weights.

* the overlap and horizon lanes (each step replayed from a CUDA graph)
  with the metrics registry and the tracer on serve the tokens, and make
  the ``host_syncs`` and ``pipeline_flushes``, of the same lanes with both
  off;
* a thread scraping ``/metrics`` and ``/stats`` in a loop while the drive
  thread captures and replays the decode graphs breaks no capture, and
  every counter it reads is monotonic;
* no callback gauge calls a torch function (so none reads a CUDA tensor),
  and a scrape makes no synchronizing CUDA call, with dispatches in
  flight.

Every test needs a card and skips without one.  The card machine has no JAX,
so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_observability_cuda.py -q
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402

from paddle_tpu_torch.inference.serving import (  # noqa: E402
    GenerationServer, generate_http)
from paddle_tpu_torch.models import graphed_step as gs  # noqa: E402
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.paged_decode import PagedKVCache  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from paddle_tpu_torch.observability import (  # noqa: E402
    Gauge, MetricsRegistry, Tracer)

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
LANES = {"overlap": {"overlap": True},
         "horizon4": {"decode_horizon": 4},
         "overlap_horizon4": {"overlap": True, "decode_horizon": 4}}
LENS = [5, 40, 17, 90, 1, 64]
NEWS = [24, 9, 30, 16, 21, 12]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gs.clear()
    yield
    gs.clear()


@pytest.fixture
def model(card):
    cfg = LlamaPretrainConfig(**KW, dtype=torch.bfloat16)
    return cfg, init_params(cfg, seed=0, device="cuda")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, KW["vocab_size"], L).tolist() for L in LENS]


def _cache(cfg):
    return PagedKVCache(cfg, num_pages=40, pages_max=8, batch=4, page=16,
                        device="cuda")


def _run(model, instrumented, **kw):
    cfg, params = model
    if instrumented:
        eng = ContinuousBatchingEngine(cfg, params, _cache(cfg),
                                       metrics_registry=MetricsRegistry(),
                                       tracer=Tracer(), **kw)
    else:
        eng = ContinuousBatchingEngine(cfg, params, _cache(cfg),
                                       metrics_registry=False, **kw)
    rids = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), NEWS)]
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    return eng, [done[r] for r in rids]


@pytest.mark.parametrize("lane", list(LANES))
def test_instrumented_graph_lanes_equal_bare(model, lane):
    bare, want = _run(model, False, **LANES[lane])
    eng, got = _run(model, True, **LANES[lane])
    assert got == want
    assert eng.host_syncs == bare.host_syncs
    assert eng.pipeline_flushes == bare.pipeline_flushes
    assert eng.decode_steps == bare.decode_steps
    reg = eng.metrics.registry
    assert reg.get("paddle_tpu_engine_tokens_generated_total").value == \
        eng.tokens_generated == sum(len(g) for g in got) - len(got)
    assert reg.get("paddle_tpu_engine_decode_step_seconds").count == \
        eng.decode_steps
    assert reg.get("paddle_tpu_request_ttft_seconds").count == len(got)
    assert reg.get("paddle_tpu_engine_inflight_dispatches_count").value == 0
    assert any(g.replays > 0 for g in gs.graphs())


def _counters(text):
    types, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            if types.get(name) == "counter":
                out[name] = float(value)
    return out


def test_scrapes_during_capture_and_replay(model):
    """The scraper runs from before the first capture to after the last
    replay; the served tokens are the bare engine's."""
    cfg, params = model
    _, want = _run(model, False, overlap=True, decode_horizon=4)
    gs.clear()                       # the served run captures anew
    srv = GenerationServer(cfg, params, _cache(cfg), overlap=True,
                           decode_horizon=4)
    port = srv.start()
    url = f"http://127.0.0.1:{port}"
    stop = threading.Event()
    reads, errors = [], []

    def scrape():
        while not stop.is_set():
            try:
                reads.append(_counters(urllib.request.urlopen(
                    url + "/metrics", timeout=30).read().decode()))
                json.loads(urllib.request.urlopen(
                    url + "/stats", timeout=30).read())
            except Exception as e:     # reported below
                errors.append(repr(e))
                return

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    results = {}

    def client(i):
        results[i] = generate_http(url, _prompts()[i], NEWS[i], timeout=300)

    try:
        # queued in order into one wave, as a direct submit lays it out
        eng, has_work = srv.engine, srv.engine.has_work

        def gated():
            if len(eng._queue) < len(LENS):
                return False
            eng.has_work = has_work
            return has_work()

        eng.has_work = gated
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(LENS))]
        for i, c in enumerate(clients):
            c.start()
            while eng._next_rid <= i:
                time.sleep(0.001)
        for c in clients:
            c.join(timeout=300)
        stop.set()
        t.join(timeout=60)
        reads.append(_counters(urllib.request.urlopen(
            url + "/metrics", timeout=30).read().decode()))
    finally:
        stop.set()
        srv.stop()
    assert errors == []
    assert [results[i] for i in range(len(LENS))] == want
    assert len(reads) > 3
    for prev, cur in zip(reads, reads[1:]):
        for name, v in prev.items():
            assert cur[name] >= v, (name, v, cur[name])
    last = reads[-1]
    assert last["paddle_tpu_engine_requests_finished_total"] == len(LENS)
    assert last["paddle_tpu_engine_decode_steps_total"] == \
        srv.engine.decode_steps
    assert any(g.replays > 0 for g in gs.graphs())


class _TorchCalls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lane", ["overlap", "overlap_horizon4"])
def test_callback_gauges_read_host_state_only(model, lane):
    cfg, params = model
    reg = MetricsRegistry()
    eng = ContinuousBatchingEngine(cfg, params, _cache(cfg),
                                   metrics_registry=reg, **LANES[lane])
    for p, n in zip(_prompts(), NEWS):
        eng.submit(p, max_new_tokens=n)
    gauges = [reg.get(n) for n in reg.names()
              if isinstance(reg.get(n), Gauge)]
    in_flight = 0
    while eng.has_work():
        eng.step()
        in_flight += bool(eng._inflight)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with _TorchCalls() as mode:
                values = [g.value for g in gauges]
                reg.render_prometheus()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert mode.calls == [], mode.calls
        assert not any(v != v for v in values)          # no NaN
    assert in_flight > 0
