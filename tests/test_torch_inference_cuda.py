"""The deployment path on a CUDA card: the kernels' ``torch.library`` ops,
the captured calls of ``jit`` / ``static`` / ``inference``, and concurrent
replays of one graph.

* every op a Layer reaches (K6a, K5, K9a, K10a, K2 and its range kernel)
  passes ``torch.library.opcheck``'s schema and fake-tensor checks: the
  fake implementation gives the kernel's output shapes and types;
* a ``Predictor`` over an exported BERT (bf16, mask-free, so K6a) replays
  one CUDA graph a signature: its outputs equal the eager forward's bit
  for bit, and each replay launches the captured K6a once a layer;
* ``jit.to_static`` on the card: the forward replay equals the eager call
  bit for bit; with grad on, the backward graph's gradients equal eager
  autograd's within 2e-2 abs + rel (one bf16 rounding, the same kernels);
  a while on a device predicate runs eagerly with the same values;
* a ``to_static`` call with grad made while an earlier call's backward is
  pending raises (the backward graph reads that call's activations); the
  calls after the backward give eager's gradients (f32, within 1e-5 rel);
  a backward whose capture a later call retook raises;
* ``static.Executor`` replays its recorded ops from a graph, the same
  values as the eager ops;
* eight threads replay one graph at once, each with its own input: every
  answer equals that input's solo run bit for bit.

Every test needs a card and skips without one; random inputs come from
explicit generators.  The card machine has no JAX, so run this file there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_inference_cuda.py -q
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import inference  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402
from paddle_tpu_torch.ops import rms_norm as rn  # noqa: E402
from paddle_tpu_torch.ops import rope as rp  # noqa: E402
from paddle_tpu_torch.ops import swiglu as sw  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = dict(atol=2e-2, rtol=2e-2)
BERT = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=512,
            max_position_embeddings=128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tplace._current_place
    paddle.set_device("gpu")
    yield torch.Generator(device="cuda").manual_seed(0)
    tplace._current_place = prev


def _t(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def test_ops_fake_shapes_match_the_kernels(card):
    gen = card
    q = _t(gen, (2, 256, 4, 128))
    x = _t(gen, (2, 256, 4, 128))
    cos, sin = rp.rope_tables(256, 128, device="cuda")
    rows, w = _t(gen, (512, 1024)), _t(gen, (1024,))
    g, u = _t(gen, (64, 2048)), _t(gen, (64, 2048))
    seg = torch.repeat_interleave(torch.arange(4, device="cuda",
                                               dtype=torch.int32), 64)[None]
    kmin, kmax = fv._ranges_op(seg, fv.BLOCK_ROWS)
    cases = [(fa._fwd_op, (q, q, q, False)),
             (rp._rope_op, (x, cos, sin, False)),
             (rn._fwd_op, (rows, w, 1e-6)),
             (sw._fwd_op, (g, u)),
             (fv._ranges_op, (seg, fv.BLOCK_ROWS)),
             (fv._seg_fwd_op, (q[:1], q[:1], q[:1], seg, kmin, kmax, True))]
    for op, args in cases:
        torch.library.opcheck(op, args,
                              test_utils=("test_schema", "test_faketensor"))


def _bert(seed=55):
    from paddle_tpu_torch.models import BertConfig, BertForQuestionAnswering
    paddle.seed(seed)
    net = BertForQuestionAnswering(BertConfig(**BERT))
    net.bfloat16()
    net.eval()
    return net


def _ids(seed, b=4, s=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, BERT["vocab_size"], (b, s)).astype(np.int64),
            np.zeros((b, s), np.int64)]


def test_predictor_replays_the_exported_program(card, tmp_path):
    net = _bert()
    ids = _ids(0)
    with paddle.no_grad():
        eager = net(*[paddle.to_tensor(a) for a in ids])
    art = inference.convert_to_export(
        net, [(a.shape, "int64") for a in ids], str(tmp_path / "bert"))
    pred = inference.create_predictor(inference.Config(art))
    fa.launches = 0
    outs = pred.run(ids)
    outs2 = pred.run(ids)
    for got, got2, want in zip(outs, outs2, eager):
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got2, got)
    call, = pred._calls.values()
    assert call.replays == 2
    assert call.capture_launches.get("flash_attention_fwd") == \
        BERT["num_hidden_layers"]
    with pytest.raises(ValueError, match="shape"):
        pred.run([a[:2] for a in ids])


def test_concurrent_replays_of_one_graph(card, tmp_path):
    net = _bert()
    ids = _ids(1)
    art = inference.convert_to_export(
        net, [(a.shape, "int64") for a in ids], str(tmp_path / "bert"))
    pred = inference.create_predictor(inference.Config(art))
    inputs = [_ids(10 + i) for i in range(8)]
    solo = [pred.run(x) for x in inputs]
    assert len(pred._calls) == 1
    got, errs = {}, []

    def worker(i):
        try:
            for _ in range(4):
                outs = pred._execute(inputs[i])
                if not all(np.array_equal(a, b)
                           for a, b in zip(outs, solo[i])):
                    got[i] = outs
        except Exception as e:          # surfaced by the assert below
            errs.append(repr(e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs and not got, (errs, sorted(got))


def test_to_static_forward_and_backward_graphs(card):
    net = _bert()
    net.train()
    for p in net.parameters():
        p.stop_gradient = False
    ids = [paddle.to_tensor(a) for a in _ids(2)]
    static = paddle.jit.to_static(net)
    with paddle.no_grad():
        want = net(*ids)
        got = static(*ids)
        got2 = static(*ids)
    for a, b, c in zip(got, got2, want):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        np.testing.assert_array_equal(b.numpy(), c.numpy())
    # with grad: a forward and a backward graph; the start logits reach
    # every parameter but the pooler's, on both paths
    loss = static(*ids)[0].astype("float32").sum()
    loss.backward()
    g_static = [p.grad for p in net.parameters()]
    net.clear_gradients()
    net(*ids)[0].astype("float32").sum().backward()
    g_eager = [p.grad for p in net.parameters()]
    assert [g is None for g in g_static] == [g is None for g in g_eager]
    assert sum(g is not None for g in g_eager) > len(g_eager) // 2
    for a, b in zip(g_static, g_eager):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    calls = list(static.forward_static.program_cache.values())
    assert any(getattr(c, "bwd_graph", None) is not None for c in calls)


class _Cell(paddle.nn.Layer):
    """h' = tanh(W x + U h): a recurrent cell, f32."""

    def __init__(self, n=64):
        super().__init__()
        self.w = paddle.nn.Linear(n, n)
        self.u = paddle.nn.Linear(n, n)

    def forward(self, x, h):
        return paddle.tanh(self.w(x) + self.u(h))


def _cell_inputs(seed, n=4, b=8, d=64):
    rng = np.random.RandomState(seed)
    xs = [paddle.to_tensor(rng.randn(b, d).astype(np.float32))
          for _ in range(n)]
    h = paddle.to_tensor(rng.randn(b, d).astype(np.float32))
    h.stop_gradient = False
    return xs, h


def _grads(net, loss):
    net.clear_gradients()
    loss.backward()
    return [p.grad.numpy() for p in net.parameters()]


# f32 with TF32 off: the replays run the eager kernels; only the order in
# which the calls' parameter gradients are summed may differ
CELL_TOL = dict(rtol=1e-5, atol=1e-6)


def test_to_static_call_before_the_pending_backward_raises(card):
    """A second call with grad before the first call's backward would
    overwrite the activations that backward reads: it raises, and after
    the backward the next calls give eager's gradients."""
    paddle.seed(7)
    net = _Cell()
    static = paddle.jit.to_static(net)
    (x1, x2), h = _cell_inputs(0, n=2)
    pending = static(x1, h).sum()
    with pytest.raises(RuntimeError, match="backward has not run yet"):
        static(x2, h)
    got = _grads(net, pending)
    want = _grads(net, net(x1, h).sum())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **CELL_TOL)
    for x in (x1, x2):
        got = _grads(net, (static(x, h) ** 2).sum())
        want = _grads(net, (net(x, h) ** 2).sum())
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **CELL_TOL)
    call, = static.forward_static.program_cache.values()
    assert len(call.slots) == 1 and call.replays == 3


def test_to_static_backward_after_its_capture_was_retaken_raises(card):
    paddle.seed(9)
    net = _Cell()
    static = paddle.jit.to_static(net)
    (x1, x2), h = _cell_inputs(2, n=2)
    loss = static(x1, h).sum()
    loss.backward(retain_graph=True)
    static(x2, h).sum().backward()      # retakes the one capture
    with pytest.raises(RuntimeError, match="replayed for a later call"):
        loss.backward()


def test_while_on_a_device_predicate_runs_eagerly(card):
    @paddle.jit.to_static
    def f(n):
        i = paddle.to_tensor(0.0)
        s = paddle.to_tensor(0.0)
        while i < n:
            s = s + i
            i = i + 1
        return s

    assert float(f(paddle.to_tensor(5.0))) == 10.0
    assert len(f._eager_keys) == 1 and not f._calls


def test_static_executor_replays_from_a_graph(card):
    static = paddle.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [None, 64], "float32")
        paddle.seed(3)
        lin = paddle.nn.Linear(64, 32)
        y = paddle.tanh(lin(x)) * 2.0
    exe = static.Executor()
    feed = np.random.RandomState(0).randn(8, 64).astype(np.float32)
    out, = exe.run(main, feed={"x": feed}, fetch_list=[y])
    out2, = exe.run(main, feed={"x": feed * 2}, fetch_list=[y])
    with paddle.no_grad():
        want = (paddle.tanh(lin(paddle.to_tensor(feed))) * 2.0).numpy()
        want2 = (paddle.tanh(lin(paddle.to_tensor(feed * 2))) * 2.0).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out2, want2, rtol=1e-6, atol=1e-6)
    call, = exe._compiled.values()
    assert call.replays == 2
