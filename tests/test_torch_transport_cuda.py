"""The sockets fleet on the card, at a small bf16 config (head_dim 128, so
the engines' admissions reach K2 and their decode steps K1):

* a spawned agent (``agent_factory.make_llama7b_engine`` with a config
  override) serves a request on the card, with the tokens of an in-process
  engine over the same seeded weights, and launches K1 and K2 in its own
  process (its counts come back through a file);
* bf16 pages, and int8 pages with their scale planes, round-trip the wire
  bit for bit (card -> host -> frame -> host -> card);
* a child's sticky CUDA error (a device-side assert) is that replica's
  death: the router fails its queued requests over to the in-process
  survivor, and the parent's CUDA context still runs K1 and serves.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_transport_cuda.py -q
"""

import json
import os
import socket

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.fleet import FleetRouter, RemoteSpec  # noqa: E402
from paddle_tpu_torch.fleet import remote, transport  # noqa: E402
from paddle_tpu_torch.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.paged_decode import PagedKVCache  # noqa: E402
from paddle_tpu_torch.models.serving_engine import (  # noqa: E402
    ContinuousBatchingEngine)
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
          dtype=torch.bfloat16)
CACHE = dict(num_pages=32, pages_max=8, batch=2, page=16)
PROMPTS = [[(7 * i + 3 * j) % 500 + 1 for j in range(L)]
           for i, L in enumerate((40, 17, 65, 9))]
FACTORY = "paddle_tpu_torch.testing.agent_factory:make_llama7b_engine"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # a child loads these libraries and refuses to build its own
    _build.build(["paged_attention", "flash_varlen"])


def _spec(tmp_path, factory=FACTORY, **kw):
    fkw = dict(CACHE, device="cuda", seed=0, config=KW,
               counts_path=str(tmp_path / "counts.json"))
    fkw.update(kw)
    return RemoteSpec(spawn={"factory": factory, "factory_kwargs": fkw,
                             "agent_kwargs": {"lease_s": 1.0}},
                      lease_s=1.0, rpc_timeout_s=0.5, max_retries=2)


def _local(params):
    cfg = LlamaPretrainConfig(**KW)

    def mk():
        return ContinuousBatchingEngine(
            cfg, params, PagedKVCache(cfg, device="cuda", **CACHE),
            metrics_registry=False)
    return mk


def _teardown(router):
    for h in router._replicas:
        if getattr(h, "_proc", None) is not None:
            if h._proc.is_alive():
                h._proc.kill()
            h._proc.join(30)


def _drive(router, rids):
    done = {}
    for _ in range(100_000):
        router.step()
        done.update((r.rid, r) for r in router.finished())
        if set(rids) <= set(done):
            return done
    raise AssertionError(f"unfinished: {set(rids) - set(done)}")


def test_a_spawned_agent_serves_on_the_card(card, tmp_path):
    params = init_params(LlamaPretrainConfig(**KW), seed=0, device="cuda")
    ref = _local(params)()
    rids = [ref.submit(p, max_new_tokens=8) for p in PROMPTS]
    want = {r.rid: [int(t) for t in r.generated]
            for r in ref.run_to_completion()}
    router = FleetRouter([_spec(tmp_path)], metrics_registry=False)
    try:
        h = router._replicas[0]
        assert h._proc.pid != os.getpid() and h.engine.device == "cuda"
        got = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
        done = _drive(router, got)
        assert [[int(t) for t in done[r].generated] for r in got] == \
            [want[r] for r in rids]
        with open(tmp_path / "counts.json") as f:
            counts = json.load(f)
        assert counts["paged_decode_attention"] > 0
        assert counts["flash_attention_segmented"] > 0
    finally:
        _teardown(router)


@pytest.mark.parametrize("q8", [False, True])
def test_pages_round_trip_the_wire_bit_for_bit(card, q8):
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (3, 2, 1, 16, 128)             # [pages, L, nkv, page, d]
    if q8:
        k = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device="cuda")
        vs = torch.rand(shape[:-1], generator=gen, device="cuda")
    else:
        k = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        ks = vs = None
    host = [None if t is None else t.cpu() for t in (k, v, ks, vs)]
    prompt = torch.arange(37)
    metas, blobs = remote._pack_record(prompt, host)
    assert metas[1]["dtype"] == ("|i1" if q8 else "<V2")
    assert metas[1]["shape"] == [2, 3, 1, 16, 128]     # JAX's [L, pages]
    a, b = socket.socketpair()
    try:
        n = transport.send_frame(a, {"metas": metas}, blobs)
        header, rblobs, m = transport.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert m == n
    back = remote._unpack_record(header["metas"], rblobs)
    assert torch.equal(back[0], prompt)
    for want, got in zip((k, v, ks, vs), back[1:]):
        if want is None:
            assert got is None
            continue
        got = got.cuda()
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == torch.bfloat16:
            want, got = want.view(torch.int16), got.view(torch.int16)
        assert torch.equal(want, got)


def test_a_childs_sticky_error_leaves_the_parent_usable(card, tmp_path):
    params = init_params(LlamaPretrainConfig(**KW), seed=0, device="cuda")
    router = FleetRouter(
        [_spec(tmp_path, factory="chip_smoke:sticky_llama7b_engine",
               fault_after=4), _local(params)],
        auto_replace=False, metrics_registry=False)
    try:
        h = router._replicas[0]
        snaps = []
        apply = h.apply_sync

        def watch(resp):
            apply(resp)
            snaps.append(dict(resp["snap"]))

        h.apply_sync = watch
        # both on the agent: the survivor out of rotation while they place
        router._replicas[1].state = "DRAINING"
        rids = [router.submit(p, max_new_tokens=24) for p in PROMPTS[:2]]
        router._replicas[1].state = "READY"
        assert [router._requests[r].replica for r in rids] == [0, 0]
        done = _drive(router, rids)
        assert router.deaths == 1
        fatal = [s for s in snaps if s.get("fatal")]
        assert fatal and fatal[-1]["state"] == "DEAD"
        assert "CUDA" in fatal[-1]["fatal"] or "device" in fatal[-1]["fatal"]
        for r in rids:
            assert done[r].status in ("ok", "error")
        h._proc.join(30)
        assert h._proc.exitcode is not None
        # the parent's context: K1 against its plain version, then a serve
        gen = torch.Generator(device="cuda").manual_seed(9)
        q = torch.randn((2, 2, 128), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kp = torch.randn((9, 1, 16, 128), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        vp = torch.randn((9, 1, 16, 128), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], device="cuda",
                              dtype=torch.int32)
        lens = torch.tensor([50, 17], device="cuda", dtype=torch.int32)
        out = pa.paged_decode_attention(q, kp, vp, tables, lens)
        plain = pa.paged_decode_attention_plain(q.float(), kp.float(),
                                                vp.float(), tables, lens)
        torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                                   rtol=2e-2)
        rid = router.submit(PROMPTS[2], max_new_tokens=8)
        more = _drive(router, [rid])
        assert more[rid].status == "ok" and len(more[rid].generated) == 8
    finally:
        _teardown(router)
